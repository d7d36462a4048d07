"""The parameters of the reference networks, {published name: shape}, from a
configuration's widths: what the benchmark draws weights for."""

from __future__ import annotations


def _conv(out, name, cin, cout, k, dims):
    out[f"{name}.weight"] = (cout, cin, *(k,) * dims)
    out[f"{name}.bias"] = (cout,)


def _norm(out, name, c):
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _dense(out, name, cin, cout):
    out[f"{name}.weight"] = (cout, cin)
    out[f"{name}.bias"] = (cout,)


def _res(out, name, cin, cout, k, dims, emb=None):
    _norm(out, f"{name}.in_norm", cin)
    _conv(out, f"{name}.in_conv", cin, cout, k, dims)
    if emb is not None:
        _dense(out, f"{name}.emb_proj", emb, cout)
    _norm(out, f"{name}.out_norm", cout)
    _conv(out, f"{name}.out_conv", cout, cout, k, dims)
    if cin != cout:
        _conv(out, f"{name}.skip", cin, cout, 1, dims)


def _attn(out, name, c, dims):
    _norm(out, f"{name}.norm", c)
    _conv(out, f"{name}.qkv", c, 3 * c, 1, dims)
    _conv(out, f"{name}.proj_out", c, c, 1, dims)


def unet(cfg: dict) -> dict:
    m, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    k, dims, attn_at = cfg["conv_kernel_size"], cfg["dims"], tuple(cfg["attention_resolutions"])
    emb, out = 4 * m, {}
    out["time_embed.W"] = (m // 2,)
    _dense(out, "time_mlp.fc1", m, emb)
    _dense(out, "time_mlp.fc2", emb, emb)
    _dense(out, "cond_mlp.fc1", cfg["cond_features"], emb)
    _dense(out, "cond_mlp.fc2", emb, emb)
    ch = m * mult[0]
    _conv(out, "in_conv", cfg["in_channels"], ch, k, dims)
    skips, ds, block = [ch], 1, 0
    for level, mu in enumerate(mult):
        for _ in range(nrb):
            _res(out, f"down_{block}_res", ch, mu * m, k, dims, emb)
            ch = mu * m
            if ds in attn_at:
                _attn(out, f"down_{block}_attn", ch, dims)
            skips.append(ch)
            block += 1
        if level != len(mult) - 1:
            _conv(out, f"down_{block}_downsample.op", ch, ch, 3, dims)  # always 3 wide
            skips.append(ch)
            ds *= 2
            block += 1
    _res(out, "mid_res1", ch, ch, k, dims, emb)
    _attn(out, "mid_attn", ch, dims)
    _res(out, "mid_res2", ch, ch, k, dims, emb)
    block = 0
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            _res(out, f"up_{block}_res", ch + skips.pop(), mult[level] * m, k, dims, emb)
            ch = mult[level] * m
            if ds in attn_at:
                _attn(out, f"up_{block}_attn", ch, dims)
            if level and i == nrb:
                _conv(out, f"up_{block}_upsample.conv", ch, ch, k, dims)
                ds //= 2
            block += 1
    _norm(out, "out_norm", ch)
    _conv(out, "out_conv", ch, cfg["out_channels"], k, dims)
    return out


def autoencoder(cfg: dict) -> dict:
    """The encoder's and the decoder's parameters (``encoder.``, ``decoder.``)."""
    out = {}
    e = cfg["encoder"]
    m, mult, nrb, k, dims = (e["model_channels"], e["channel_mult"], e["num_res_blocks"],
                             e["conv_kernel_size"], e["dims"])
    ch = m * mult[0]
    _conv(out, "encoder.in_conv", e["in_channels"], ch, k, dims)
    block = 0
    for level, mu in enumerate(mult):
        for _ in range(nrb):
            _res(out, f"encoder.down_{block}_res", ch, mu * m, k, dims)
            ch = mu * m
            block += 1
        if level != len(mult) - 1:
            _conv(out, f"encoder.down_{block}_downsample.op", ch, ch, 3, dims)
            block += 1
    _conv(out, "encoder.out_conv", ch, e["out_channels"], k, dims)
    d = cfg["decoder"]
    m, mult, nrb, k, dims = (d["model_channels"], d["channel_mult"], d["num_res_blocks"],
                             d["conv_kernel_size"], d["dims"])
    ch = m * mult[-1]
    _conv(out, "decoder.in_conv", d["in_channels"], ch, k, dims)
    block = 0
    for level in reversed(range(len(mult))):
        if level != len(mult) - 1:
            _conv(out, f"decoder.up_{block}_upsample.conv", ch, ch, 3, dims)
            block += 1
        for _ in range(nrb):
            _res(out, f"decoder.up_{block}_res", ch, mult[level] * m, k, dims)
            ch = mult[level] * m
            block += 1
    _conv(out, "decoder.out_conv", ch, d["out_channels"], k, dims)
    return out
