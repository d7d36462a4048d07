"""Reference (Lightning) checkpoints -> the port's ``state_dict``s: the port of
``tqdne_tpu/utils/torch_convert.py``.

The reference's released weights (Zenodo records 15687691 / 16405538) are
Lightning ``.ckpt`` files of PyTorch modules.  The port names its modules
after the JAX package's flax scopes (``utils/convert.py``), so converting is
a renaming walk over the architecture config; both sides are PyTorch, so
every tensor keeps its layout (convolutions OIHW, linear layers (O, I)):

  reference                                port
  ---------------------------------------  --------------------------------
  time_embed.W                             time_embed.W
  time_mlp.0 / time_mlp.2                  time_mlp.fc1 / fc2
  cond_mlp.0 / cond_mlp.2                  cond_mlp.fc1 / fc2
  input_blocks.0.0                         in_conv
  input_blocks.i.0 (ResBlock)              down_{i-1}_res
  input_blocks.i.1 (AttentionBlock)        down_{i-1}_attn
  input_blocks.i.0.op (Downsample)         down_{i-1}_downsample.op
  middle_block.{0,1,2}                     mid_res1 / mid_attn / mid_res2
  output_blocks.j.{...}                    up_{j}_res / up_{j}_attn /
                                           up_{j}_upsample.conv
  out.0 / out.2                            out_norm / out_conv
  ResBlock in_layers.0 / .2                in_norm / in_conv
           emb_layers.1                    emb_proj
           out_layers.0 / .3               out_norm / out_conv
           skip_connection                 skip
  AttentionBlock norm / qkv / proj_out     norm / qkv / proj_out
  Encoder/Decoder input_layer, output_layer in_conv, out_conv
           down_blocks.k / up_blocks.k     down_{b}_* / up_{b}_* (flattened)
  classifier output_MLP.1 / .3, output_layer  mlp1 / mlp2, head

A UNet's per-feature conditioning embedding ``cond_embed.W`` is taken when
its ``cfg`` has ``cond_emb_scale``, and refused when it does not (the port's
UNet would have no place for it).  A scale-shift ``emb_layers.1`` is twice
as wide and maps as any other; a model without resampling convolutions
(``conv_resample=False``) has no ``op`` or ``conv`` to map.
``load_state_dict(strict=True)`` of the result into the port's module checks
every name and shape.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


def _modules(sd: dict, pairs) -> dict[str, torch.Tensor]:
    """``<src>.weight`` and ``<src>.bias`` as ``<dst>.*`` for each pair."""
    return {f"{dst}.{leaf}": _tensor(sd[f"{src}.{leaf}"])
            for src, dst in pairs for leaf in ("weight", "bias")}


def _resblock(sd: dict, src: str, dst: str, emb: bool = True) -> list:
    pairs = [(f"{src}.in_layers.0", f"{dst}.in_norm"), (f"{src}.in_layers.2", f"{dst}.in_conv"),
             (f"{src}.out_layers.0", f"{dst}.out_norm"),
             (f"{src}.out_layers.3", f"{dst}.out_conv")]
    if emb:
        pairs.append((f"{src}.emb_layers.1", f"{dst}.emb_proj"))
    if f"{src}.skip_connection.weight" in sd:
        pairs.append((f"{src}.skip_connection", f"{dst}.skip"))
    return pairs


def _attention(src: str, dst: str) -> list:
    return [(f"{src}.{m}", f"{dst}.{m}") for m in ("norm", "qkv", "proj_out")]


def strip_prefix(state_dict: dict, prefix: str) -> dict:
    """Select keys under ``prefix.`` (e.g. 'unet', 'encoder') and strip it."""
    plen = len(prefix) + 1
    return {k[plen:]: v for k, v in state_dict.items() if k.startswith(prefix + ".")}


def convert_unet(state_dict: dict, cfg: dict) -> dict[str, torch.Tensor]:
    """The reference ``UNetModel``'s state dict -> the port's ``UNet``'s.
    ``cfg`` is the architecture (model_channels, channel_mult,
    num_res_blocks, attention_resolutions, cond_features, ...)."""
    sd = state_dict
    embedded = cfg.get("cond_features") is not None and cfg.get("cond_emb_scale") is not None
    if "cond_embed.W" in sd and not embedded:
        raise ValueError("the checkpoint's UNet has a per-feature conditioning embedding "
                         "(cond_embed.W), but its config sets no cond_emb_scale")
    mult = tuple(cfg["channel_mult"])
    nrb = int(cfg["num_res_blocks"])
    attn_res = set(cfg.get("attention_resolutions", ()))
    resample = cfg.get("conv_resample", True)

    pairs = [("time_mlp.0", "time_mlp.fc1"), ("time_mlp.2", "time_mlp.fc2"),
             ("input_blocks.0.0", "in_conv"), ("out.0", "out_norm"), ("out.2", "out_conv"),
             *_resblock(sd, "middle_block.0", "mid_res1"),
             *_attention("middle_block.1", "mid_attn"),
             *_resblock(sd, "middle_block.2", "mid_res2")]
    if cfg.get("cond_features") is not None:
        pairs += [("cond_mlp.0", "cond_mlp.fc1"), ("cond_mlp.2", "cond_mlp.fc2")]

    # down path: input_blocks index i >= 1 maps to down_{i-1}
    i, ds = 1, 1
    for level in range(len(mult)):
        for _ in range(nrb):
            pairs += _resblock(sd, f"input_blocks.{i}.0", f"down_{i - 1}_res")
            if ds in attn_res:
                pairs += _attention(f"input_blocks.{i}.1", f"down_{i - 1}_attn")
            i += 1
        if level != len(mult) - 1:
            if resample:
                pairs.append((f"input_blocks.{i}.0.op", f"down_{i - 1}_downsample.op"))
            i += 1
            ds *= 2

    # up path: output_blocks index j maps to up_{j}
    j = 0
    for level in reversed(range(len(mult))):
        for k in range(nrb + 1):
            pairs += _resblock(sd, f"output_blocks.{j}.0", f"up_{j}_res")
            idx = 1
            if ds in attn_res:
                pairs += _attention(f"output_blocks.{j}.{idx}", f"up_{j}_attn")
                idx += 1
            if level and k == nrb:
                if resample:
                    pairs.append((f"output_blocks.{j}.{idx}.conv", f"up_{j}_upsample.conv"))
                ds //= 2
            j += 1

    fourier = ["time_embed.W"] + (["cond_embed.W"] if embedded else [])
    return _modules(sd, pairs) | {key: _tensor(sd[key]) for key in fourier}


def _conv_stack(sd: dict, cfg: dict, prefix: str, *, decoder: bool) -> list:
    """Encoder/Decoder: the reference's flattened ``down_blocks.k`` /
    ``up_blocks.k`` sequence against the port's per-role names."""
    mult = tuple(cfg["channel_mult"])
    nrb = int(cfg["num_res_blocks"])
    attn_res = set(cfg.get("attention_resolutions", ()))
    resample = cfg.get("conv_resample", True)
    seq = f"{prefix}.up_blocks" if decoder else f"{prefix}.down_blocks"
    pairs = [(f"{prefix}.input_layer", f"{prefix}.in_conv"),
             (f"{prefix}.output_layer", f"{prefix}.out_conv")]
    k = 0  # the reference's flattened index
    b = 0  # the port's block counter
    if not decoder:
        ds = 1
        for level in range(len(mult)):
            for _ in range(nrb):
                pairs += _resblock(sd, f"{seq}.{k}", f"{prefix}.down_{b}_res", emb=False)
                k += 1
                if ds in attn_res:
                    pairs += _attention(f"{seq}.{k}", f"{prefix}.down_{b}_attn")
                    k += 1
                b += 1
            if level != len(mult) - 1:
                if resample:
                    pairs.append((f"{seq}.{k}.op", f"{prefix}.down_{b}_downsample.op"))
                k += 1
                b += 1
                ds *= 2
    else:
        ds = 2 ** (len(mult) - 1)
        for level in reversed(range(len(mult))):
            if level != len(mult) - 1:
                if resample:
                    pairs.append((f"{seq}.{k}.conv", f"{prefix}.up_{b}_upsample.conv"))
                k += 1
                b += 1
                ds //= 2
            for _ in range(nrb):
                pairs += _resblock(sd, f"{seq}.{k}", f"{prefix}.up_{b}_res", emb=False)
                k += 1
                if ds in attn_res:
                    pairs += _attention(f"{seq}.{k}", f"{prefix}.up_{b}_attn")
                    k += 1
                b += 1
    return pairs


def convert_autoencoder(state_dict: dict, encoder_cfg: dict,
                        decoder_cfg: dict) -> dict[str, torch.Tensor]:
    """The reference ``LightningAutoencoder``'s state dict (``encoder.*`` /
    ``decoder.*``) -> the port's ``AutoencoderKL``'s."""
    pairs = (_conv_stack(state_dict, encoder_cfg, "encoder", decoder=False)
             + _conv_stack(state_dict, decoder_cfg, "decoder", decoder=True))
    return _modules(state_dict, pairs)


def convert_classifier(state_dict: dict, encoder_cfg: dict) -> dict[str, torch.Tensor]:
    """The reference classifier's state dict (``encoder.*``, ``output_MLP``,
    ``output_layer``) -> the port's ``Classifier``'s."""
    pairs = _conv_stack(state_dict, encoder_cfg, "encoder", decoder=False) + [
        ("output_MLP.1", "mlp1"), ("output_MLP.3", "mlp2"), ("output_layer", "head")]
    return _modules(state_dict, pairs)


def read_checkpoint(path) -> dict:
    """A Lightning ``.ckpt`` as saved.  Lightning pickles ``hyper_parameters``
    beside the tensors, so this needs ``weights_only=False`` (the default
    since torch 2.6 is True): read only checkpoints from a trusted source."""
    return torch.load(path, map_location="cpu", weights_only=False)


def ema_state_dict(ckpt: dict, base_sd: dict, prefix: str) -> dict | None:
    """The EMA weights of a Lightning checkpoint: the EMA callback's
    ``ema_state`` (trainable parameters only, by parameter name; at the top
    level or under ``callbacks``) merged over ``base_sd``, the checkpoint's
    ``state_dict`` with ``prefix`` stripped; None when there is none."""
    ema = None
    for container in (ckpt, ckpt.get("callbacks", {})):
        if isinstance(container, dict):
            for key, val in container.items():
                if key == "ema_state":
                    ema = val
                elif isinstance(val, dict) and "ema_state" in val:
                    ema = val["ema_state"]
    if ema is None:
        return None
    merged = dict(base_sd)
    plen = len(prefix) + 1 if prefix else 0
    for name, tensor in ema.items():
        name = name[plen:] if prefix and name.startswith(prefix + ".") else name
        if name in merged:
            merged[name] = tensor
    return merged


def load_lightning_checkpoint(path, prefix: str = "unet", *,
                              ema: bool = False) -> tuple[dict, dict]:
    """(the ``state_dict`` under ``prefix``, prefix stripped, and the
    ``hyper_parameters``) of a Lightning ``.ckpt``; ``ema=True``: the EMA
    weights merged over it where the checkpoint holds them."""
    ckpt = read_checkpoint(path)
    sd = dict(ckpt["state_dict"])
    sd = strip_prefix(sd, prefix) if prefix else sd
    if ema:
        sd = ema_state_dict(ckpt, sd, prefix) or sd
    return sd, dict(ckpt.get("hyper_parameters", {}))
