"""The arithmetic of the Hopper kernels K1 (CiM fake-quant matmul) and K2
(flash attention), emulated in PyTorch on the CPU and held against the plain
versions and the JAX package.

The CUDA kernels themselves run only on the card (``chip_smoke.py``). What
they compute differently from their plain versions is checked here:

* K1 rounds a tile's integer dot p by an estimate ``rint(p * (1/step))``
  corrected with exact integer thresholds (``fq_thresholds``), and sums the
  tiles' quantized dots exactly (integers, in float32 below 2^24) before one
  multiply by the step;
* K2 splits float32 operands into three bf16 pieces whose sum is exact, and
  runs q.k^T and p.v as bf16 products accumulated in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.cim_matmul import cim_matmul_pallas
from repro_torch.device import divisor
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cim_matmul import cim_matmul_fq_plain, fq_cluster_size, fq_thresholds

# ---------------------------------------------------------------------------
# K1: threshold-corrected rounding, exact sums
# ---------------------------------------------------------------------------


_MAGIC = 3 << 22  # 1.5 * 2^23: floats in [2^23, 2^24) are the integers


def _rne_shift(n: torch.Tensor, s: int) -> torch.Tensor:
    """round_half_even(n / 2^s) for int64 ``n``, exactly."""
    q = n >> s
    rem = n - (q << s)
    half = 1 << (s - 1)
    return q + ((rem > half) | ((rem == half) & (q % 2 == 1))).long()


def _kernel_round(p: torch.Tensor, rows: int, step: float) -> torch.Tensor:
    """K1's rounding of integer tile dots ``p`` (int64), step by step, in
    exact integer arithmetic: the estimate r = fma(f, fl32(1/step), c) (one
    rounding, to the integers of [2^23, 2^24)) with f = p + 1.5 * 2^23 and
    c = fl32(1.5 * 2^23 * (1 - 1/step)), or, for wide tiles (|p| may reach
    2^22), f = p and c = 1.5 * 2^23; then the two thresholds around it."""
    thr = fq_thresholds(rows, step, "cpu").to(torch.int64)
    off = (thr.numel() - 2) // 2
    inv = np.float32(1.0) / np.float32(step)
    mant, exp = np.frexp(inv)  # inv = mant * 2^exp, mant in [1/2, 1)
    inv_int, shift = int(mant * 2**24), 24 - int(exp)  # inv = inv_int / 2^shift exactly
    wide = rows << 14 >= 1 << 22
    f = p if wide else p + _MAGIC
    c = _MAGIC if wide else int(np.float32(float(_MAGIC) * (1.0 - float(inv))))
    idx = _rne_shift(f * inv_int, shift) + c - _MAGIC + off
    assert bool((idx >= 0).all()) and bool((idx + 1 < thr.numel()).all())  # the estimate stays in the table
    return idx - (p < thr[idx]).long() + (p >= thr[idx + 1]).long() - off


def _kernel_fq(x: torch.Tensor, w: torch.Tensor, rows: int, step: float, splits: int = 1) -> torch.Tensor:
    """K1's whole function: exact int tile dots, rounded as above, summed
    exactly over the tiles (in ``splits`` contiguous ranges, as the cluster
    split does, then added), times the step once in float32."""
    m, k = x.shape
    t = k // rows
    p = torch.einsum("mtr,trn->mtn", x.long().reshape(m, t, rows), w.long().reshape(t, rows, -1))
    q = _kernel_round(p, rows, step)
    bounds = [t * r // splits for r in range(splits + 1)]
    qsum = sum(q[:, a:b].sum(dim=1) for a, b in zip(bounds, bounds[1:]))
    return qsum.to(torch.int32).to(torch.float32) * torch.tensor(step, dtype=torch.float32)


@pytest.mark.parametrize(
    "rows,adc_bits,a_bits,w_bits",
    [(16, 5, 8, 8), (10, 5, 8, 8), (48, 3, 4, 4), (48, 8, 8, 8), (64, 6, 8, 8), (128, 8, 8, 8)],
)
def test_fq_threshold_rounding_is_exact_for_every_dot(rows, adc_bits, a_bits, w_bits):
    """Every integer p a tile of int8 products can reach: the kernel's
    rounding equals the true float32 divide and half-even round."""
    step = tref.fake_quant_step(rows, adc_bits, a_bits, w_bits, True, True)
    p = torch.arange(-(rows << 14), (rows << 14) + 1, dtype=torch.int64)
    want = torch.round(p.to(torch.float32) / divisor(step, p)).to(torch.int64)
    assert torch.equal(_kernel_round(p, rows, step), want)


@pytest.mark.parametrize("rows,adc_bits", [(256, 8), (1024, 10)])
def test_fq_threshold_rounding_wide_tiles(rows, adc_bits):
    """Tiles whose dots may reach 2^22 (rows >= 256) take the kernel's wide
    estimate: every p within 3 of a threshold, and a stride through the rest."""
    step = tref.fake_quant_step(rows, adc_bits, 8, 8, True, True)
    thr = fq_thresholds(rows, step, "cpu")[2:-2].to(torch.int64)
    near = (thr[:, None] + torch.arange(-3, 4)[None, :]).flatten()
    p = torch.cat([near, torch.arange(-(rows << 14), (rows << 14) + 1, 997)])
    want = torch.round(p.to(torch.float32) / divisor(step, p)).to(torch.int64)
    assert torch.equal(_kernel_round(p, rows, step), want)


def test_fq_thresholds_are_cached_and_bracket_each_step():
    step = tref.fake_quant_step(16, 5, 8, 8, True, True)
    thr = fq_thresholds(16, step, "cpu")
    assert thr is fq_thresholds(16, step, "cpu")
    q_max = (thr.numel() - 4) // 2
    assert q_max == 24  # round(16 * 2^14 / 10922.5)
    assert thr.dtype == torch.int32 and bool((thr[1:] >= thr[:-1]).all())
    inner = thr[2:-2].long()
    q = lambda p: torch.round(p.float() / divisor(step, p)).long()  # noqa: E731
    j = torch.arange(-q_max + 1, q_max + 1)
    assert torch.equal(q(inner), j) and torch.equal(q(inner - 1), j - 1)


def test_fq_cluster_size():
    assert fq_cluster_size(4, 36) == 8 and fq_cluster_size(64, 3) == 3
    assert fq_cluster_size(65, 36) == 1 and fq_cluster_size(1024, 96) == 1


@pytest.mark.parametrize(
    "m,k,n,rows,adc_bits,lo,hi,splits",
    [
        (8, 64, 24, 16, 5, -128, 128, 1),   # default CiMConfig
        (4, 16 * 37, 16, 16, 5, -128, 128, 8),  # 37 tiles over a cluster of 8
        (5, 40, 7, 10, 5, -128, 128, 3),    # rows 10: tiles padded to 16
        (3, 192, 16, 64, 6, -128, 128, 2),
        (6, 256, 8, 16, 5, -128, -127, 8),  # saturating -128 operands: every tile at q = 24
        (16, 256, 8, 128, 8, -128, 128, 1),
    ],
)
def test_fq_int_sums_bit_exact_to_plain_and_pallas(m, k, n, rows, adc_bits, lo, hi, splits):
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.integers(lo, hi, (m, k)).astype(np.float32)
    w = rng.integers(lo, hi, (k, n)).astype(np.float32)
    if lo == -128 and hi == -127:
        w[:, ::2] = 127  # both ends of the table: q = +-24 per tile
    step = tref.fake_quant_step(rows, adc_bits, 8, 8, True, True)
    y = _kernel_fq(torch.from_numpy(x).to(torch.int8), torch.from_numpy(w).to(torch.int8), rows, step, splits)
    y_plain = cim_matmul_fq_plain(torch.from_numpy(x), torch.from_numpy(w), rows=rows, step=step)
    assert torch.equal(y, y_plain)
    y_pl = cim_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), rows=rows, adc_bits=adc_bits, mode="fake_quant",
        block_m=m, block_n=n, block_k=k, interpret=True,
    )
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_pl))


# ---------------------------------------------------------------------------
# K2: exact bf16 splits, tensor-core arithmetic
# ---------------------------------------------------------------------------


def _split3(x: torch.Tensor):
    """K2's split of float32 ``x``: three pieces, each ``x`` so far with its
    low 16 bits cleared (truncation), so each is a bf16 value."""
    pieces = []
    for _ in range(3):
        hi = (x.view(torch.int32) & -65536).view(torch.float32)
        pieces.append(hi)
        x = x - hi
    return pieces


def test_bf16_split_reconstructs_float32_exactly():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(4096).astype(np.float32)
    wide = (rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 127, 4096)).astype(np.float32)
    ends = np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, np.finfo(np.float32).max,
                     -np.finfo(np.float32).max, 2.0 ** -100, 1.0 - 2.0 ** -24], dtype=np.float32)
    x = torch.from_numpy(np.concatenate([normal, wide, ends]))
    pieces = _split3(x)
    for piece in pieces:
        assert torch.isfinite(piece).all()
        assert torch.equal(piece.to(torch.bfloat16).to(torch.float32), piece)  # bf16-exact
    total = pieces[0].double() + pieces[1].double() + pieces[2].double()
    assert torch.equal(total, x.double())
    assert torch.equal(torch.signbit(pieces[0][4096 * 2 + 1]), torch.tensor(True))  # -0 stays -0


def _tc_dot(a: torch.Tensor, b: torch.Tensor, pieces: int) -> torch.Tensor:
    """a (..., r, d) float32 times b (..., d, c), bf16-exact, as K2's MMAs
    do it: ``pieces`` bf16 pieces of ``a`` (smallest first), every product
    exact, sums in float32."""
    parts = _split3(a) if pieces == 3 else [a]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for part in reversed(parts):
        out = out + part @ b
    return out


def _tc_flash(q, k, v, *, causal, sm_scale=None, block_k=64):
    """K2's tensor-core kernel in PyTorch: float32 q scaled and split in
    three, k/v bf16, online softmax over 64-key tiles, p split in three."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    qf = q.float().reshape(b, kv, g, sq, hd) * sm_scale
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    pos = torch.arange(sq)[:, None]
    m = torch.full((b, kv, g, sq, 1), -1e30)
    l = torch.zeros((b, kv, g, sq, 1))
    acc = torch.zeros((b, kv, g, sq, hd))
    for k0 in range(0, sk, block_k):
        s = _tc_dot(qf, kf[..., k0:k0 + block_k, :].transpose(-1, -2), 3)
        ok = (k0 + torch.arange(s.shape[-1]))[None, :] <= pos if causal else torch.ones_like(s, dtype=torch.bool)
        s = torch.where(ok, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _tc_dot(p, vf[..., k0:k0 + block_k, :], 3)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).reshape(b, h, sq, hd)


@pytest.mark.parametrize(
    "b,h,kv,sq,sk,hd,causal",
    [
        (2, 4, 2, 256, 256, 64, True),
        (1, 8, 8, 128, 384, 32, True),
        (2, 4, 1, 256, 256, 64, False),
        (1, 2, 2, 512, 512, 128, True),
        (1, 9, 3, 256, 256, 64, True),  # one batch row of the serve shape
    ],
)
def test_flash_bf16_split_arithmetic_matches_jax_ref(b, h, kv, sq, sk, hd, causal):
    """The serve path's dtypes (q float32, k/v bf16) through K2's split
    arithmetic: within 1e-5 of the JAX fp32 reference."""
    rng = np.random.default_rng(b * 100 + h + sk)
    q = rng.standard_normal((b, h, sq, hd)).astype(np.float32)
    k = torch.from_numpy(rng.standard_normal((b, kv, sk, hd)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((b, kv, sk, hd)).astype(np.float32)).to(torch.bfloat16)
    o = _tc_flash(torch.from_numpy(q), k, v, causal=causal)
    o_j = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy()), causal=causal
    ))
    np.testing.assert_allclose(o.numpy(), o_j, atol=1e-5, rtol=0)
