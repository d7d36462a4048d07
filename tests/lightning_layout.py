"""Reference-layout Lightning checkpoints from the port's modules, for the
checkpoint tests and ``chip_smoke.py``: no reference checkpoint is
downloaded, so a port module's weights are renamed to the reference's key
layout (the layout ``tqdne_tpu/utils/torch_convert.py`` reads), written from
the reference's module structure, independently of either package's
converter.  Imports torch only.
"""

import re

import torch

RES = {"in_norm": "in_layers.0", "in_conv": "in_layers.2", "emb_proj": "emb_layers.1",
       "out_norm": "out_layers.0", "out_conv": "out_layers.3", "skip": "skip_connection"}


def _block(kind: str, rest: str) -> str:
    """A ResBlock's inner names; attention (norm, qkv, proj_out) and the
    resampling convolutions (op, conv) keep theirs."""
    if kind != "res":
        return rest
    head, _, tail = rest.partition(".")
    return f"{RES[head]}.{tail}"


def _reference_unet_key(key: str, port_sd: dict) -> str:
    top, _, rest = key.partition(".")
    fixed = {"in_conv": "input_blocks.0.0", "out_norm": "out.0", "out_conv": "out.2",
             "mid_attn": "middle_block.1"}
    if top in fixed:
        return f"{fixed[top]}.{rest}"
    if top in ("mid_res1", "mid_res2"):
        return f"middle_block.{0 if top == 'mid_res1' else 2}.{_block('res', rest)}"
    if top in ("time_mlp", "cond_mlp"):
        return f"{top}.{ {'fc1': '0', 'fc2': '2'}[rest.split('.')[0]]}.{rest.split('.')[1]}"
    if top in ("time_embed", "cond_embed"):
        return key
    side, i, kind = re.fullmatch(r"(down|up)_(\d+)_(\w+)", top).groups()
    i = int(i)
    if side == "down":  # input_blocks.0 is the input convolution
        return f"input_blocks.{i + 1}.{1 if kind == 'attn' else 0}.{_block(kind, rest)}"
    slot = {"res": 0, "attn": 1}.get(kind)
    if slot is None:  # the upsample follows the block's attention, where it has one
        slot = 2 if f"up_{i}_attn.norm.weight" in port_sd else 1
    return f"output_blocks.{i}.{slot}.{_block(kind, rest)}"


def _reference_stack_key(key: str, module) -> str:
    """``encoder.*`` / ``decoder.*``: the reference's flattened block sequence."""
    prefix, top, rest = key.split(".", 2)
    stack = getattr(module, prefix)
    if top in ("in_conv", "out_conv"):
        return f"{prefix}.{'input_layer' if top == 'in_conv' else 'output_layer'}.{rest}"
    seq = "down_blocks" if prefix == "encoder" else "up_blocks"
    kind = top.rsplit("_", 1)[1]
    return f"{prefix}.{seq}.{stack.order.index(top)}.{_block(kind, rest)}"


def reference_state_dict(module, kind: str) -> dict:
    """The port module's weights under the reference's key names (numpy)."""
    sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    heads = {"mlp1": "output_MLP.1", "mlp2": "output_MLP.3", "head": "output_layer"}
    out = {}
    for key, value in sd.items():
        if kind == "unet":
            out[_reference_unet_key(key, sd)] = value
        elif key.split(".")[0] in heads:
            top, leaf = key.split(".")
            out[f"{heads[top]}.{leaf}"] = value
        else:
            out[_reference_stack_key(key, module)] = value
    return out


def lightning_checkpoint(live: dict, ema: dict | None, *, step: int, prefix: str = "",
                         in_callbacks: bool = False) -> dict:
    """A Lightning checkpoint dict of reference state dicts: ``state_dict``
    (keys under ``prefix.``), ``global_step``, ``hyper_parameters`` and the
    EMA callback's ``ema_state`` at the top level or under ``callbacks``."""
    def tensors(sd):
        dot = prefix + "." if prefix else ""
        return {dot + k: torch.as_tensor(v) for k, v in sd.items()}

    ckpt = {"state_dict": tensors(live), "global_step": step, "hyper_parameters": {}}
    if ema is not None:
        if in_callbacks:
            ckpt["callbacks"] = {"EMA": {"ema_state": tensors(ema)}}
        else:
            ckpt["ema_state"] = tensors(ema)
    return ckpt
