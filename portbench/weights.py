"""Weights of a configuration, made on the device from the seed.

The layout (names, shapes, dtypes) is the one the program serves: a frozen
copy of the port's init layout (``models/layers.py``, ``transformer.py``,
``mamba2.py``, ``zamba2.py`` under ``src/repro_torch``): fan-scaled weights
and Mamba2's ``A_log``, ``D``, ``dt_bias`` in float32, the embedding table,
norm scales and conv biases in ``param_dtype``. The values are the
benchmark's own: every normal leaf is a slice of one ``randn`` on the
device and every uniform one a slice of one ``rand``, so a configuration of
billions of weights costs a few launches. Norm scales and biases are drawn
too (the port's init sets them to zero), so the reference sees them matter.
The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

__all__ = ["layout", "make_params", "n_bytes"]

# (kind, fan): "fan" = N(0, 1/fan) float32; "embed" = N(0, 0.02²) and
# "small" = N(0, 0.1²) in param_dtype; "a_log", "dt_bias", "d_skip" uniform draws.


def _attention(run, lead):
    d, h, kv, hd = run["d_model"], run["n_heads"], run["n_kv_heads"], run["head_dim"]
    return {
        "wq": (lead + (d, h * hd), "fan", d), "wk": (lead + (d, kv * hd), "fan", d),
        "wv": (lead + (d, kv * hd), "fan", d), "wo": (lead + (h * hd, d), "fan", h * hd),
    }


def _mlp(run, lead):
    d, f = run["d_model"], run["d_ff"]
    return {"w_gate": (lead + (d, f), "fan", d), "w_up": (lead + (d, f), "fan", d),
            "w_down": (lead + (f, d), "fan", f)}


def _embed(run):
    v = -(-run["vocab"] // run["pad_vocab_multiple"]) * run["pad_vocab_multiple"]
    e = {"tok": ((v, run["d_model"]), "embed", 0)}
    if not run["tie_embeddings"]:
        e["unembed"] = ((run["d_model"], v), "fan", run["d_model"])
    return e


def _mamba(run):
    nl, d = run["n_layers"], run["d_model"]
    di = run["ssm_expand"] * d
    h, n, w = di // run["ssm_headdim"], run["ssm_state"], run["ssm_conv_width"]
    return {
        "in_z": ((nl, d, di), "fan", d), "in_x": ((nl, d, di), "fan", d),
        "in_b": ((nl, d, n), "fan", d), "in_c": ((nl, d, n), "fan", d), "in_dt": ((nl, d, h), "fan", d),
        "conv_x": ((nl, w, di), "fan", w), "conv_b": ((nl, w, n), "fan", w), "conv_c": ((nl, w, n), "fan", w),
        "conv_x_bias": ((nl, di), "small", 0), "conv_b_bias": ((nl, n), "small", 0),
        "conv_c_bias": ((nl, n), "small", 0),
        "A_log": ((nl, h), "a_log", 0), "D": ((nl, h), "d_skip", 0), "dt_bias": ((nl, h), "dt_bias", 0),
        "norm": ((nl, di), "small", 0), "out_proj": ((nl, di, d), "fan", di),
    }


def layout(run: dict) -> dict:
    """The params tree of ``run`` as ``{name: (shape, kind, fan)}`` leaves."""
    nl, d = run["n_layers"], run["d_model"]
    if run["family"] == "dense":
        return {"embed": _embed(run), "attn": _attention(run, (nl,)),
                "ln1": ((nl, d), "small", 0), "ln2": ((nl, d), "small", 0), "ln_f": ((d,), "small", 0),
                "mlp": _mlp(run, (nl,))}
    if run["family"] == "hybrid":
        return {"embed": _embed(run), "mamba": _mamba(run), "mamba_ln": ((nl, d), "small", 0),
                "shared": {"attn": _attention(run, ()), "mlp": _mlp(run, ()),
                           "ln1": ((d,), "small", 0), "ln2": ((d,), "small", 0)},
                "ln_f": ((d,), "small", 0)}
    raise ValueError(f"no weight layout for family {run['family']!r}")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_UNIFORM = {"a_log": (1.0, 16.0), "dt_bias": (1e-3, 1e-1), "d_skip": (0.5, 1.5)}


def make_params(run: dict, seed: int, device) -> dict:
    """The params of ``run`` from ``seed``, on ``device``: one ``randn`` for
    every normal leaf and one ``rand`` for every uniform leaf."""
    leaves = list(_leaves(layout(run)))
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = [(p, s, k, f) for p, (s, k, f) in leaves if k not in _UNIFORM]
    uniform = [(p, s, k, f) for p, (s, k, f) in leaves if k in _UNIFORM]
    z = torch.randn(sum(math.prod(s) for _, s, _, _ in normal), generator=gen, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _, _ in uniform), generator=gen, device=device)
    pdt = getattr(torch, run["param_dtype"])
    out: dict = {}
    for buf, group in ((z, normal), (u, uniform)):
        at = 0
        for path, shape, kind, fan in group:
            n = math.prod(shape)
            x = buf[at:at + n].view(shape)
            at += n
            if kind == "fan":
                t = x.mul_(1.0 / math.sqrt(fan))
            elif kind in ("embed", "small"):
                t = (x * (0.02 if kind == "embed" else 0.1)).to(pdt)
            else:
                lo, hi = _UNIFORM[kind]
                t = x.mul_(hi - lo).add_(lo)
                if kind == "a_log":
                    t = t.log_()
                elif kind == "dt_bias":
                    t = torch.log(torch.expm1(t))
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
    return out


def n_bytes(params: dict) -> int:
    """Bytes the params take on the device."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(params))
