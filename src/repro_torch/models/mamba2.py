"""Mamba2 (SSD, state-space duality) blocks of the PyTorch port, chunked
prefill and single-step decode (counterpart of ``repro.models.mamba2``).

The sequence is padded to whole chunks (padded steps get dt = 0, so the
state neither decays nor updates); the intra-chunk term is a masked
"attention-like" product and the inter-chunk term a short loop over chunk
states, all in float32. Decode is the O(1) state recurrence. Every
projection goes through ``layers.dense``, so with ``fake_quant`` CiM it runs
the CiM fake-quant kernel.

Parameter layout per stacked layer dim L (one SSM group), as in the JAX
package: ``in_z``, ``in_x`` (L, D, d_inner); ``in_b``, ``in_c`` (L, D, N);
``in_dt`` (L, D, H); ``conv_{x,b,c}`` (L, W, ·) and their ``_bias``;
``A_log``, ``D``, ``dt_bias`` (L, H) in float32; ``norm`` (L, d_inner);
``out_proj`` (L, d_inner, D).

One device: the JAX package's sharding constraints have no counterpart here.
The state is updated in place (the JAX functions return a new state); the
functions return the same dict, so callers read it alike. The training
forward runs ``mamba_forward`` without a state: it starts from zero and
writes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _fan_normal, cdtype, dense, pdtype, rms_norm

__all__ = ["init_mamba", "mamba_forward", "mamba_decode_step", "make_mamba_state"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n_layers: int):
    """Random init from ``gen`` (the JAX package's names, shapes and dtypes)."""
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    w = cfg.ssm_conv_width
    dt, dev = pdtype(cfg), gen.device
    nrm = lambda shape, fan: _fan_normal(gen, shape, fan, dt)  # noqa: E731
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        (n_layers, h), generator=gen, dtype=torch.float32, device=dev
    )
    zeros = lambda width: torch.zeros((n_layers, width), dtype=dt, device=dev)  # noqa: E731
    return {
        "in_z": nrm((n_layers, d, di), d),
        "in_x": nrm((n_layers, d, di), d),
        "in_b": nrm((n_layers, d, n), d),
        "in_c": nrm((n_layers, d, n), d),
        "in_dt": nrm((n_layers, d, h), d),
        "conv_x": nrm((n_layers, w, di), w),
        "conv_b": nrm((n_layers, w, n), w),
        "conv_c": nrm((n_layers, w, n), w),
        "conv_x_bias": zeros(di),
        "conv_b_bias": zeros(n),
        "conv_c_bias": zeros(n),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones((n_layers, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 1e-1))),
        "norm": zeros(di),
        "out_proj": nrm((n_layers, di, d), di),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C): the causal conv as W shifted adds in x's dtype,
    summed in the JAX package's order (``F.conv1d`` sums in another)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        y = y + xp[:, i : i + s, :] * w[i]
    return y + b


def mamba_forward(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    state: Optional[dict] = None,  # one layer's state, written in place
):
    """Full-sequence SSD from ``state["ssm"]`` (zero without a state).
    Returns ``(y, state)``: the final SSM state and conv tails are left in
    ``state``; without one (training) nothing is written and the state
    returned is None."""
    bsz, s_orig, d = x.shape
    di, h, n, ph = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim
    q = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % q
    if pad:  # pad the sequence; padded steps get dt = 0 (state frozen)
        x = F.pad(x, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q
    seq_mask = (torch.arange(s, device=x.device) < s_orig).float()

    cim = cfg.cim
    z = dense(x, p["in_z"], None, cim)
    xs = dense(x, p["in_x"], None, cim)
    b_ = dense(x, p["in_b"], None, cim)
    c_ = dense(x, p["in_c"], None, cim)
    dt = dense(x, p["in_dt"], None, cim)

    cw = lambda t: t.to(x.dtype)  # noqa: E731
    xs_raw, b_raw, c_raw = xs, b_, c_
    xs = F.silu(_causal_depthwise_conv(xs, cw(p["conv_x"]), cw(p["conv_x_bias"])))
    b_ = F.silu(_causal_depthwise_conv(b_, cw(p["conv_b"]), cw(p["conv_b_bias"])))
    c_ = F.silu(_causal_depthwise_conv(c_, cw(p["conv_c"]), cw(p["conv_c_bias"])))
    xs = xs.reshape(bsz, s, h, ph)

    dt = _softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    dt = dt * seq_mask[None, :, None]  # padded steps: no state update or decay
    a = -torch.exp(p["A_log"])  # (H,)
    da = dt * a

    # chunked SSD in float32
    xf = xs.float().reshape(bsz, nc, q, h, ph)
    bf = b_.float().reshape(bsz, nc, q, n)
    cf = c_.float().reshape(bsz, nc, q, n)
    dtc = dt.reshape(bsz, nc, q, h)
    da_cs = torch.cumsum(da.reshape(bsz, nc, q, h), dim=2)  # (B, NC, Q, H)

    # intra-chunk: Y[q] = sum_{k<=q} C_q.B_k * exp(cs_q - cs_k) * dt_k * x_k
    att = torch.einsum("bcqn,bckn->bcqk", cf, bf)
    seg = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B, NC, Q, K, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask before exp: above the diagonal seg is large and positive, and
    # exp-then-mask would give inf * 0 = NaN
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, -torch.inf))
    w_qk = att[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", w_qk, xf)
    del seg, decay, w_qk

    # chunk states: S_c = sum_k B_k (x) x_k * dt_k * exp(cs_last - cs_k)
    decay_out = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B, NC, Q, H)
    sterm = torch.einsum("bckn,bckh,bckhp->bchpn", bf, dtc * decay_out, xf)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # (B, NC, H)

    s_prev = state["ssm"].float() if state is not None else torch.zeros((bsz, h, ph, n), device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + sterm[:, c]
    s_last, s_prevs = s_prev, torch.stack(s_prevs, dim=1)  # (B, NC, H, P, N)

    # inter-chunk: Y_off[q] = C_q . S_prev * exp(cs_q)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", cf, s_prevs, torch.exp(da_cs))
    y = (y + y_off).reshape(bsz, s, h, ph)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(bsz, s, di).to(x.dtype)[:, :s_orig]

    # gated RMSNorm + out proj
    y = rms_norm(y * F.silu(z[:, :s_orig]), p["norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"], None, cim)

    if state is None:
        return out, None
    w1 = cfg.ssm_conv_width - 1

    def tail(t):
        return F.pad(t[:, :s_orig], (0, 0, max(0, w1 - s_orig), 0))[:, -w1:, :]

    state["ssm"].copy_(s_last)
    for name, t in (("conv_x", xs_raw), ("conv_b", b_raw), ("conv_c", c_raw)):
        state[name].copy_(tail(t))
    return out, state


def mamba_decode_step(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cfg: ModelConfig,
    state: dict,  # {"ssm": (B, H, P, N) f32, "conv_{x,b,c}": (B, W-1, .)}, written in place
):
    """One token through the state recurrence; returns ``(y, state)``."""
    bsz = x.shape[0]
    di, h, ph = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    cim = cfg.cim

    x0 = x[:, 0, :]
    z = dense(x0, p["in_z"], None, cim)
    xs = dense(x0, p["in_x"], None, cim)
    b_ = dense(x0, p["in_b"], None, cim)
    c_ = dense(x0, p["in_c"], None, cim)
    dt = dense(x0, p["in_dt"], None, cim)

    def conv_step(name, new):  # the float32 window of W-1 past inputs and the new one
        win = torch.cat([state[name], new[:, None, :].to(state[name].dtype)], dim=1)
        out = F.silu(
            torch.einsum("bwc,wc->bc", win.float(), p[name].float()) + p[name + "_bias"].float()
        )
        state[name].copy_(win[:, 1:, :])
        return out

    xs_c = conv_step("conv_x", xs).reshape(bsz, h, ph)
    b_c = conv_step("conv_b", b_)
    c_c = conv_step("conv_c", c_)

    dt = _softplus(dt.float() + p["dt_bias"])  # (B, H)
    da = torch.exp(dt * -torch.exp(p["A_log"]))

    s_new = state["ssm"] * da[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xs_c, b_c)
    state["ssm"].copy_(s_new)
    y = torch.einsum("bhpn,bn->bhp", s_new, c_c) + p["D"][None, :, None] * xs_c
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None, :].to(x.dtype)), p["norm"], cfg.norm_eps)
    return dense(y, p["out_proj"], None, cim), state


def make_mamba_state(cfg: ModelConfig, batch: int, n_layers: int, device):
    """Zero state of ``n_layers`` layers: the float32 SSM state and the conv
    windows of the last W-1 inputs in the compute dtype."""
    di, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    w1 = cfg.ssm_conv_width - 1
    dt = cdtype(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, h, cfg.ssm_headdim, n), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((n_layers, batch, w1, di), dtype=dt, device=device),
        "conv_b": torch.zeros((n_layers, batch, w1, n), dtype=dt, device=device),
        "conv_c": torch.zeros((n_layers, batch, w1, n), dtype=dt, device=device),
    }
