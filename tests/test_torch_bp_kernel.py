"""The arithmetic of the Hopper kernel K3 (bit-plane CiM matmul,
``csrc/cim_matmul_bp.cu``), emulated on the CPU and held against the plain
version and the JAX package's Pallas kernel.

The CUDA kernel runs only on the card (``chip_smoke.py``). What it computes
differently from its plain version is checked here:

* plane fragments straight from the pattern words, ``P & (0x01010101 << p)``
  (bytes 0 or 2^p) on both sides, so an accumulator holds 2^(a+b) times the
  plane dot, and the 4 x 4 byte transpose of a staged weight tile;
* the code of a plane dot d, ``min(floor(fl32(d / rows) * 2^B), 2^B - 1)``:
  on the FAST path (rows a power of two, B >= log2 rows) made without the
  divide, by two float operations on the accumulator read as
  ``1.5 * 2^23 + 2^(a+b) d``; on the INT path by the plain version's own
  formula, IEEE divide included;
* exact sums of the signed codes (a tile's in float32 below 2^24 and the
  totals in int32 on the FAST path, int64 otherwise), split over CTAs in any
  order, converted once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_matmul import cim_matmul_pallas
from repro_torch.device import divisor
from repro_torch.kernels.cim_matmul import bp_cluster_size, bp_fast, cim_matmul_bp_plain

_MAGIC = 1.5 * 2.0 ** 23  # the FAST epilogue's accumulator start, as a float


def _float_code(d: np.ndarray, rows: np.ndarray, bits: int) -> np.ndarray:
    """K3's INT epilogue code: IEEE float32 divide, scale, floor, clamp."""
    mav = d.astype(np.float32) / rows.astype(np.float32)
    return np.minimum(np.floor(mav * np.float32(1 << bits)), (1 << bits) - 1).astype(np.int64)


def _every_dot(rows_list):
    """(d, rows): every plane dot d = 0..rows of every rows in ``rows_list``."""
    rows = np.repeat(rows_list, [r + 1 for r in rows_list])
    d = np.concatenate([np.arange(r + 1) for r in rows_list])
    return d, rows


def test_bp_int_code_equals_plain_codes_for_every_dot():
    """The INT epilogue's code against the codes the plain version computes
    (torch on the CPU: a divide by a 0-d tensor, scale, floor, clamp) for
    every rows 1..1024, every d = 0..rows and every ADC width 1..24."""
    d, rows = _every_dot(list(range(1, 1025)))
    d_t, rows_t = torch.from_numpy(d).float(), torch.from_numpy(rows).float()
    for bits in range(1, 25):
        n_codes = 1 << bits
        want = torch.clamp(torch.floor(d_t / rows_t * n_codes), 0, n_codes - 1).long().numpy()
        np.testing.assert_array_equal(_float_code(d, rows, bits), want, err_msg=f"{bits} bits")
    for r in (3, 10, 24, 1000):  # one rows at a time, as ref divides (by a 0-d tensor)
        d_r = torch.arange(r + 1, dtype=torch.float32)
        want = torch.clamp(torch.floor(d_r / divisor(r, d_r) * 32), 0, 31).long().numpy()
        np.testing.assert_array_equal(_float_code(d_r.long().numpy(), np.full(r + 1, r), 5), want)


@pytest.mark.parametrize("bits", range(1, 25))
def test_bp_fast_code_from_the_magic_accumulator(bits):
    """FAST path: the accumulator's bits are those of 1.5 * 2^23 plus
    2^(a+b) d (both planes masked in place), so it reads as that float
    exactly (at most 2^24, since A + W + r <= 24 there); one FMA with
    2^(B - r - a - b) and -1.5 * 2^23 * 2^(B - r - a - b) gives d 2^(B - r)
    exactly, and the clamp makes it the plain version's code, for every d,
    plane pair and power-of-two rows the FAST path takes at this ADC width."""
    for r in range(min(bits, 10) + 1):
        rows = 1 << r
        d = np.arange(rows + 1, dtype=np.int64)
        want = _float_code(d, np.full(rows + 1, rows), bits)
        for ab in range(15):  # a + b, up to (A - 1) + (W - 1) with A + W <= 24 - r
            if not bp_fast(rows, bits, 1, ab + 1, 1):  # the widest plane pair a + b the FAST path meets
                continue
            acc_bits = np.int32(0x4B400000) + (d << ab).astype(np.int32)
            f = acc_bits.view(np.float32).astype(np.float64)
            assert np.array_equal(f, _MAGIC + (d << ab))
            q = 2.0 ** (bits - r - ab)
            c = np.minimum(f * q - _MAGIC * q, (1 << bits) - 1)  # exact in float64: one rounding
            assert np.array_equal(c.astype(np.float32).astype(np.float64), c)
            np.testing.assert_array_equal(c.astype(np.int64), want)
    assert bp_fast(1 << min(bits, 10), bits, 1, 1, 1) == (bits + 2 <= 24)


def test_plane_fragments_from_pattern_words():
    """A plane of four pattern bytes, masked in place: ``P & (0x01010101 << p)``
    holds 2^p times ``ref``'s ``(x >> p) & 1`` in every byte, and the
    unsigned 8-bit product of two such bytes is 2^(a+b) times the plane
    product, so an s32 accumulator of 16 or 32 of them holds 2^(a+b) d."""
    rng = np.random.default_rng(0)
    pat = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    words = pat.view("<u4")  # four k-neighbours per 32-bit word, as a fragment register holds them
    for p in range(8):
        plane = (words & (0x01010101 << p)).astype("<u4").view(np.uint8)
        np.testing.assert_array_equal(plane, ((pat >> p) & 1) << p)
    xa = (pat[:16] & (1 << 7)).astype(np.int64)  # plane 7 of 16 rows, as the kernel holds it
    wb = (pat[16:].T & (1 << 6)).astype(np.int64)  # plane 6 of 16 columns
    np.testing.assert_array_equal(xa @ wb, (((pat[:16] >> 7) & 1).astype(np.int64) @ ((pat[16:].T >> 6) & 1)) << 13)
    assert int((xa @ wb).max()) < 1 << 22


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of y:x."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def test_staged_weight_transpose_by_byte_perm():
    """The kernel's 4 x 4 byte transpose of a staged w block (rows k, columns
    n) into four words of k-neighbours, one per column."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        blk = rng.integers(0, 256, (4, 4), dtype=np.uint8)
        r0, r1, r2, r3 = (int(v) for v in blk.view("<u4")[:, 0])
        t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
        t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
        out = [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
               _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
        np.testing.assert_array_equal(np.array(out, dtype="<u4").view(np.uint8).reshape(4, 4), blk.T)


def _kernel_bp(x_pat, w_pat, *, rows, adc_bits, a_bits, w_bits, a_signed=True, w_signed=True,
               splits=1, track=None):
    """K3's whole function on two's-complement patterns (int64 tensors):
    plane dots as the accumulators hold them (2^(a+b) d), the FAST or the INT
    epilogue's codes, exact sums per tile, the tiles split into ``splits``
    contiguous ranges (the cluster split) added last to first, and one
    conversion, fl32(I * rows) * 2^-B. ``track``, a list, gets the largest
    partial tile sum after each plane pair."""
    m, k = x_pat.shape
    n = w_pat.shape[1]
    t = k // rows
    r = rows.bit_length() - 1
    fast = bp_fast(rows, adc_bits, a_bits, w_bits, t)
    n_max = (1 << adc_bits) - 1
    xp, wp = x_pat.long().reshape(m, t, rows), w_pat.long().reshape(t, rows, n)
    per_tile = torch.zeros((m, t, n), dtype=torch.float64 if fast else torch.int64)
    for a in range(a_bits):
        xa = ((xp >> a) & 1) << a
        for b in range(w_bits):
            d2 = torch.einsum("mtr,trn->mtn", xa, ((wp >> b) & 1) << b)  # 2^(a+b) d
            neg = (a_signed and a == a_bits - 1) != (w_signed and b == w_bits - 1)
            s = -(1 << (a + b)) if neg else 1 << (a + b)
            if fast:  # float32 operations, emulated in float64 where each is exact
                f = _MAGIC + d2.double()
                assert float(f.max()) <= 2 ** 24  # the accumulator's bits read as this float
                q = 2.0 ** (adc_bits - r - a - b)
                per_tile += torch.clamp(f * q - _MAGIC * q, max=n_max) * s
                assert float(per_tile.abs().max()) < 2 ** 24  # every partial sum exact in float32
            else:
                dots = (d2 >> (a + b)).numpy()
                per_tile += torch.from_numpy(_float_code(dots, np.full(dots.shape, rows), adc_bits)) * s
            if track is not None:  # the largest partial sum so far
                track.append(float(per_tile.abs().max()))
    per_tile = per_tile.long()
    bounds = [t * i // splits for i in range(splits + 1)]
    total = torch.zeros((m, n), dtype=torch.int64)
    for lo, hi in reversed(list(zip(bounds, bounds[1:]))):
        total += per_tile[:, lo:hi].sum(dim=1)
    return (total * rows).to(torch.float32) * 2.0 ** -adc_bits


def _pallas(x_pat, w_pat, **kw):
    m, k = x_pat.shape
    n = w_pat.shape[1]
    return np.asarray(cim_matmul_pallas(
        jnp.asarray(x_pat.numpy().astype(np.int32)), jnp.asarray(w_pat.numpy().astype(np.int32)),
        mode="bitplane", block_m=m, block_n=n, block_k=k, interpret=True, **kw))


@pytest.mark.parametrize(
    "m,k,n,rows,adc_bits,a_bits,w_bits,a_signed,splits",
    [
        (9, 64, 12, 16, 5, 4, 4, True, 1),     # the chip geometry: FAST
        (33, 40, 17, 10, 5, 3, 5, True, 3),    # rows 10: INT, tiles padded to 16
        (20, 128, 33, 64, 5, 3, 5, True, 2),   # rows 64, 5-bit ADC (B < log2 rows): INT
        (7, 256, 24, 128, 8, 5, 3, True, 2),   # rows 128: FAST (ops defaults' widths, fewer planes)
        (12, 64, 40, 16, 5, 4, 4, False, 4),   # unsigned activations, split over 4
        (5, 96, 9, 32, 6, 3, 5, True, 3),      # rows 32, 6-bit ADC: FAST
        (8, 48, 12, 24, 20, 1, 1, False, 2),   # rows 24, 20-bit ADC: INT
        (6, 96, 20, 48, 7, 4, 6, True, 2),     # rows 48 (three k-steps of 16), 7-bit ADC: INT
    ],
)
def test_bp_kernel_arithmetic_bit_exact_to_plain_and_pallas(m, k, n, rows, adc_bits, a_bits, w_bits, a_signed, splits):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.integers(0, 1 << a_bits, (m, k)))
    w = torch.from_numpy(rng.integers(0, 1 << w_bits, (k, n)))
    kw = dict(rows=rows, adc_bits=adc_bits, a_bits=a_bits, w_bits=w_bits, a_signed=a_signed)
    y = _kernel_bp(x, w, splits=splits, **kw)
    assert torch.equal(y, cim_matmul_bp_plain(x, w, **kw))
    np.testing.assert_array_equal(y.numpy(), _pallas(x, w, **kw))


def test_bp_kernel_saturating_operands():
    """Every plane dot equals rows (all-ones patterns): each code clamps to
    2^B - 1. At rows 16, a 5-bit ADC, 4/4 bits and 4 tiles the plain
    version's float32 sums are exact (at most 4 * 31 * 2^8 granules), so the
    kernel's arithmetic must equal it bit for bit."""
    kw = dict(rows=16, adc_bits=5, a_bits=4, w_bits=4)
    x, w = torch.full((6, 64), 15, dtype=torch.int64), torch.full((64, 10), 15, dtype=torch.int64)
    y = _kernel_bp(x, w, splits=3, **kw)
    assert torch.equal(y, cim_matmul_bp_plain(x, w, **kw))
    np.testing.assert_array_equal(y.numpy(), _pallas(x, w, **kw))
    # (sum_a s_a)(sum_b s_b) = (-1)(-1) per tile; each pair's count reads 15.5 of 16
    assert torch.equal(y, torch.full((6, 10), 4 * 15.5))


def test_bp_accumulator_regimes_at_the_widest_sums():
    """The FAST path's float32 tile sums hold up to A + W + B = 24 (the ops
    defaults, saturated) and its int32 totals up to 127 such tiles; the
    widest K3 takes, 8 + 8 + 24 bits, goes to the INT epilogue's int64 sums:
    there a tile's signed codes pass 2^31, yet the result equals the plain
    version wherever that is exact (rows 16: the counts are whole plane
    dots)."""
    assert bp_fast(128, 8, 8, 8, 127) and not bp_fast(128, 8, 8, 8, 128)
    assert not bp_fast(128, 9, 8, 8, 1) and not bp_fast(16, 24, 8, 8, 1) and bp_fast(16, 5, 4, 4, 96)
    track = []
    sat = dict(rows=128, adc_bits=8, a_bits=8, w_bits=8)
    x, w = torch.full((2, 128), 255, dtype=torch.int64), torch.full((128, 3), 127, dtype=torch.int64)
    y = _kernel_bp(x, w, track=track, **sat)  # asserts every partial sum below 2^24
    assert torch.equal(y, cim_matmul_bp_plain(x, w, **sat))
    assert max(track) >= 2 ** 21  # 127 * 127 * 255 after the positive planes
    rng = np.random.default_rng(3)
    wide = dict(rows=16, adc_bits=24, a_bits=8, w_bits=8)
    x = torch.from_numpy(rng.integers(0, 256, (4, 32)))
    w = torch.from_numpy(rng.integers(0, 256, (32, 6)))
    track.clear()
    y = _kernel_bp(x, w, splits=2, track=track, **wide)
    assert max(track) >= 2 ** 31  # an int32 tile sum would wrap
    assert torch.equal(y, cim_matmul_bp_plain(x, w, **wide))
    np.testing.assert_array_equal(y.numpy(), _pallas(x, w, **wide))


def test_bp_cluster_size():
    assert bp_cluster_size(4, 192, 5) == 5 and bp_cluster_size(4, 1536, 36) == 3
    assert bp_cluster_size(4, 576, 96) == 8 and bp_cluster_size(64, 576, 12) == 8
    assert bp_cluster_size(65, 33, 96) == 1 and bp_cluster_size(1024, 192, 5) == 1
    assert bp_cluster_size(1, 16, 1) == 1
