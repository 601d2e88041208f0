"""PyTorch port vs JAX package: the kernels' plain versions, the oracles and
the CiM matmul, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX Pallas CiM and ADC kernels run in interpret mode; the JAX flash kernel
does not run on this jax version, so the port's attention is held against
``repro.kernels.ref.flash_attention_ref``.

Where a comparison is bit-exact, the JAX side runs eagerly (unjitted): under
``jax.jit`` XLA turns a division by a constant (``absmax / qmax`` in the
quantizer, ``v / vdd`` in the ADC) into a multiplication by its reciprocal,
which the port does not do (it divides, on every device, as eager JAX does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_linear as jcl
from repro.core.cim_array import bit_planes as j_bit_planes
from repro.kernels import ref as jref
from repro.kernels.cim_matmul import adc_quant_pallas, cim_matmul_pallas
from repro.kernels.ops import adc_quant_op as j_adc_quant_op
from repro.kernels.ops import cim_matmul_op as j_cim_matmul_op
from repro_torch.core import cim_linear as tcl
from repro_torch.core.cim_array import bit_planes, from_bit_planes, plane_weights
from repro_torch.device import divisor
from repro_torch.kernels import adc_quant_op, cim_matmul_op
from repro_torch.kernels import ref as tref
from repro_torch.kernels.adc_quant import adc_quant
from repro_torch.kernels.cim_matmul import cim_matmul_bp, cim_matmul_fq
from repro_torch.kernels.flash_attention import flash_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_REF_STATIC = ("rows", "adc_bits", "mode", "a_bits", "w_bits", "a_signed", "w_signed", "exact_counts")
j_cim_matmul_ref = jax.jit(jref.cim_matmul_ref, static_argnames=_REF_STATIC)
j_flash_ref = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "sm_scale"))
j_cim_matmul = jax.jit(jcl.cim_matmul, static_argnums=2)


def _ints(shape, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# bit planes, quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,signed", [(8, True), (4, False), (5, True)])
def test_bit_planes_and_weights_match_jax(bits, signed):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    x = np.random.default_rng(0).integers(lo, hi, (6, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        bit_planes(_t(x), bits, signed).numpy(), np.asarray(j_bit_planes(jnp.asarray(x), bits, signed))
    )
    from repro.core.cim_array import plane_weights as j_plane_weights

    np.testing.assert_array_equal(plane_weights(bits, signed), j_plane_weights(bits, signed))
    from repro.core.cim_array import from_bit_planes as j_from_bit_planes

    planes = bit_planes(_t(x), bits, signed)
    back = from_bit_planes(planes, bits, signed)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_from_bit_planes(jnp.asarray(planes.numpy()), bits, signed)))


@pytest.mark.parametrize("bits,signed,per_axis", [(8, True, None), (8, True, -1), (4, False, 0)])
def test_quantize_symmetric_bit_exact(bits, signed, per_axis):
    x = _normal((33, 40), 1) * 3.0
    xi_t, s_t = tcl.quantize_symmetric(_t(x), bits, signed, per_axis=per_axis)
    xi_j, s_j = jcl.quantize_symmetric(jnp.asarray(x), bits, signed, per_axis=per_axis)
    np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.mark.parametrize("value", [0.8, 10.0, 127.0, 10922.5])
def test_divisor_is_a_true_divide(value):
    x = _normal((64, 65), 2) * 50.0
    d = divisor(value, _t(x))
    assert d.shape == () and d.dtype == torch.float32 and d.device.type == "cpu"
    np.testing.assert_array_equal((_t(x) / d).numpy(), x / np.float32(value))
    assert divisor(127, _t(x), torch.bfloat16).dtype == torch.bfloat16
    # one kept constant per (value, dtype, device), made in inference mode and
    # still usable where autograd saves it
    with torch.inference_mode():
        assert divisor(value, _t(x)) is d
    w = torch.ones(3, requires_grad=True)
    (w / divisor(value, w)).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.float32(1.0) / np.full(3, value, np.float32))


# ---------------------------------------------------------------------------
# K1: CiM fake-quant matmul
# ---------------------------------------------------------------------------


def test_fake_quant_step_matches_jax():
    for args in ((16, 5, 8, 8, True, True), (64, 6, 8, 8, True, True), (128, 8, 4, 6, False, True)):
        assert tref.fake_quant_step(*args) == jref.fake_quant_step(*args)


def test_cim_kernel_plain_bit_exact_default_config():
    """The default CiMConfig (rows 16, adc 5, 8/8-bit signed): K1's plain
    version equals the JAX oracle and the Pallas kernel bit for bit, on
    integer inputs over the full int8 range."""
    cfg = tcl.CiMConfig()
    m, k, n = 128, 512, 128
    xi, wi = _ints((m, k), -128, 128, 2), _ints((k, n), -128, 128, 3)
    step = tref.fake_quant_step(cfg.rows, cfg.adc_bits, 8, 8, True, True)
    y_t = cim_matmul_fq(_t(xi), _t(wi), rows=cfg.rows, step=step).numpy()
    kw = dict(rows=cfg.rows, adc_bits=cfg.adc_bits, mode="fake_quant")
    y_ref = np.asarray(j_cim_matmul_ref(jnp.asarray(xi), jnp.asarray(wi), **kw))
    y_pl = np.asarray(cim_matmul_pallas(jnp.asarray(xi), jnp.asarray(wi), block_k=512, interpret=True, **kw))
    np.testing.assert_array_equal(y_t, y_ref)
    np.testing.assert_array_equal(y_t, y_pl)
    np.testing.assert_array_equal(tref.cim_matmul_ref(_t(xi), _t(wi), **kw).numpy(), y_ref)


def test_cim_kernel_plain_rows64_adc6():
    m, k, n = 128, 512, 128
    xi, wi = _ints((m, k), -128, 128, 4), _ints((k, n), -128, 128, 5)
    step = tref.fake_quant_step(64, 6, 8, 8, True, True)
    y_t = cim_matmul_fq(_t(xi), _t(wi), rows=64, step=step).numpy()
    kw = dict(rows=64, adc_bits=6, mode="fake_quant")
    y_pl = np.asarray(cim_matmul_pallas(jnp.asarray(xi), jnp.asarray(wi), block_k=512, interpret=True, **kw))
    np.testing.assert_allclose(y_t, y_pl, rtol=1e-5)
    np.testing.assert_allclose(y_t, np.asarray(j_cim_matmul_ref(jnp.asarray(xi), jnp.asarray(wi), **kw)), rtol=1e-5)


@pytest.mark.parametrize("a_bits,w_bits,rows,adc_bits", [(4, 4, 16, 5), (3, 5, 64, 7)])
def test_bitplane_oracle_matches_jax(a_bits, w_bits, rows, adc_bits):
    xi = _ints((32, 128), -(1 << (a_bits - 1)), 1 << (a_bits - 1), 6)
    wi = _ints((128, 24), -(1 << (w_bits - 1)), 1 << (w_bits - 1), 7)
    kw = dict(rows=rows, adc_bits=adc_bits, mode="bitplane", a_bits=a_bits, w_bits=w_bits)
    np.testing.assert_array_equal(
        tref.cim_matmul_ref(_t(xi), _t(wi), **kw).numpy(),
        np.asarray(j_cim_matmul_ref(jnp.asarray(xi), jnp.asarray(wi), **kw)),
    )


@pytest.mark.parametrize("a_bits,w_bits,rows,adc_bits", [(4, 4, 128, 8), (3, 5, 64, 7), (4, 4, 16, 5)])
def test_bitplane_kernel_plain_matches_pallas(a_bits, w_bits, rows, adc_bits):
    """K3's plain version (the wrapper on CPU tensors) against the Pallas
    bit-plane kernel in interpret mode, on the JAX package's own sweep:
    bit-exact, on signed integers and on their two's-complement patterns."""
    m, k, n = 128, 512, 128
    xi = np.random.default_rng(20).integers(-(1 << (a_bits - 1)), 1 << (a_bits - 1), (m, k)).astype(np.int32)
    wi = np.random.default_rng(21).integers(-(1 << (w_bits - 1)), 1 << (w_bits - 1), (k, n)).astype(np.int32)
    kw = dict(rows=rows, adc_bits=adc_bits, a_bits=a_bits, w_bits=w_bits)
    y_pl = np.asarray(cim_matmul_pallas(jnp.asarray(xi), jnp.asarray(wi), mode="bitplane", interpret=True, **kw))
    np.testing.assert_array_equal(cim_matmul_bp(_t(xi), _t(wi), **kw).numpy(), y_pl)
    xp, wp = xi + (xi < 0) * (1 << a_bits), wi + (wi < 0) * (1 << w_bits)
    np.testing.assert_array_equal(cim_matmul_bp(_t(xp), _t(wp), **kw).numpy(), y_pl)


def _saturation_deficit(xi, wi, rows, a_bits, w_bits):
    """Half the signed plane weight of every (tile, plane pair) whose
    ``rows`` bits are all set on both sides, summed per output: a 16-row
    count reads as 15.5 through a 5-bit ADC (code 32 does not exist)."""
    def side(v, bits, axis_rows):  # (outputs, T): weighted all-ones planes per tile
        p = np.where(v < 0, v + (1 << bits), v)
        p = p.reshape(p.shape[0], -1, rows) if axis_rows == 0 else p.T.reshape(p.shape[1], -1, rows)
        wts = plane_weights(bits, True)
        return sum(wts[b] * ((p >> b) & 1).all(axis=-1) for b in range(bits))
    return 0.5 * (side(xi, a_bits, 0) @ side(wi, w_bits, 1).T)


def test_bitplane_kernel_exact_on_chip_geometry():
    """rows 16 + 5-bit ADC, 4/4 bits: K3's plain version is the integer
    matmul, less half a plane weight for each saturated (16-of-16) plane pair
    of a tile; two such tiles are planted."""
    xi = np.random.default_rng(22).integers(-8, 8, (128, 512)).astype(np.int32)
    wi = np.random.default_rng(23).integers(-8, 8, (512, 128)).astype(np.int32)
    xi[0, :16], wi[:16, 0] = -1, -1  # all four planes full on both sides
    xi[1, 16:32], wi[16:32, 1] = 7, -8
    deficit = _saturation_deficit(xi, wi, 16, 4, 4)
    assert np.count_nonzero(deficit) >= 2
    y = cim_matmul_bp(_t(xi), _t(wi), rows=16, adc_bits=5, a_bits=4, w_bits=4).numpy()
    np.testing.assert_array_equal(y, (xi @ wi - deficit).astype(np.float32))


@pytest.mark.parametrize(
    "shape,k,n,kw",
    [
        ((2, 5), 96, 24, dict(rows=16, adc_bits=5, a_bits=4, w_bits=4)),  # JAX pads K to 512
        ((7,), 200, 40, dict(rows=64, adc_bits=6, a_bits=3, w_bits=5, a_signed=False)),
        ((3,), 130, 20, dict()),  # the ops' defaults: rows 128, adc 8, 8/8 bits; K padded
    ],
)
def test_cim_matmul_op_bitplane_matches_jax_op(shape, k, n, kw):
    x = _normal(shape + (k,), 24)
    if kw.get("a_signed") is False:
        x = np.abs(x)
    w = (_normal((k, n), 25) / np.sqrt(k)).astype(np.float32)
    y_t = cim_matmul_op(_t(x), _t(w), mode="bitplane", **kw).numpy()
    with jax.disable_jit():
        y_j = np.asarray(j_cim_matmul_op(jnp.asarray(x), jnp.asarray(w), mode="bitplane", interpret=True, **kw))
    assert y_t.shape == shape + (n,)
    np.testing.assert_array_equal(y_t, y_j)


@pytest.mark.parametrize("shape", [(7, 130), (100, 100), (256, 512), (1, 31)])
@pytest.mark.parametrize("bits", [3, 5, 8])
def test_adc_quant_op_matches_jax_op(shape, bits):
    v = np.random.default_rng(26).uniform(0, 1, shape).astype(np.float32)
    got = adc_quant_op(_t(v), bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_adc_quant_op(jnp.asarray(v), bits=bits, interpret=True)))
    with pytest.raises(ValueError, match="2-D"):
        adc_quant_op(_t(v).reshape(-1), bits=bits)


def test_adc_quant_oracle_matches_jax():
    v = np.random.default_rng(8).uniform(-0.2, 1.2, (16, 40)).astype(np.float32)
    for bits in (3, 5):
        np.testing.assert_array_equal(
            tref.adc_quant_ref(_t(v), bits).numpy(), np.asarray(jref.adc_quant_ref(jnp.asarray(v), bits))
        )


@pytest.mark.parametrize("bits", [3, 5, 8])
def test_adc_quant_vdd_below_one_matches_jax(bits):
    """vdd 0.8: the port's oracle and K4's plain version divide by vdd. They
    equal the JAX oracle run eagerly bit for bit, and the Pallas kernel
    (interpret mode, jitted) everywhere except where XLA's multiply by the
    float32 reciprocal of vdd floors to another code than the divide."""
    vdd, n = 0.8, 1 << bits
    v = np.random.default_rng(9).uniform(-0.2, 1.2, (256, 512)).astype(np.float32)
    got = adc_quant(_t(v), bits=bits, vdd=vdd).numpy()
    np.testing.assert_array_equal(got, tref.adc_quant_ref(_t(v), bits, vdd).numpy())
    np.testing.assert_array_equal(got, np.asarray(jref.adc_quant_ref(jnp.asarray(v), bits, vdd)))
    pallas = np.asarray(adc_quant_pallas(jnp.asarray(v), bits=bits, vdd=vdd, interpret=True))
    f32 = np.float32
    divide = np.floor(v / f32(vdd) * f32(n))
    reciprocal = np.floor(v * (f32(1) / f32(vdd)) * f32(n))
    np.testing.assert_array_equal(got != pallas, divide != reciprocal)
    assert (got != pallas).sum() <= 1e-4 * v.size


@pytest.mark.parametrize(
    "shape,k,n,rows,adc_bits,ste",
    [
        ((2, 8), 576, 192, 16, 5, False),  # smollm q/k/v width, default CiM arrays
        ((24,), 100, 48, 16, 5, True),  # K padded to a multiple of rows; STE
        ((3, 5), 192, 64, 64, 8, False),
    ],
)
def test_cim_matmul_fake_quant_matches_jax(shape, k, n, rows, adc_bits, ste):
    x = _normal(shape + (k,), 9)
    w = (_normal((k, n), 10) / np.sqrt(k)).astype(np.float32)
    cfg_t = tcl.CiMConfig(mode="fake_quant", rows=rows, adc_bits=adc_bits, ste=ste)
    cfg_j = jcl.CiMConfig(mode="fake_quant", rows=rows, adc_bits=adc_bits, ste=ste)
    y_t = tcl.cim_matmul(_t(x), _t(w), cfg_t).numpy()
    y_j = np.asarray(j_cim_matmul(jnp.asarray(x), jnp.asarray(w), cfg_j))
    assert y_t.shape == y_j.shape == shape + (n,)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


def test_cim_matmul_op_matches_jax_op():
    x = _normal((3, 7, 96), 11)
    w = (_normal((96, 40), 12) / np.sqrt(96)).astype(np.float32)
    kw = dict(rows=16, adc_bits=5)
    y_t = cim_matmul_op(_t(x), _t(w), **kw).numpy()
    y_j = np.asarray(j_cim_matmul_op(jnp.asarray(x), jnp.asarray(w), interpret=True, **kw))
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


def test_cim_matmul_exact_and_unported_modes():
    x, w = _t(_normal((4, 32), 13)), _t(_normal((32, 8), 14))
    y, stats = tcl.cim_matmul(x, w, tcl.CiMConfig(mode="exact"), return_stats=True)
    torch.testing.assert_close(y, x @ w)
    assert int(stats.conversions) == 0
    # bitplane is ported: equal to the JAX package's (run eagerly), stats too
    cfg = dict(mode="bitplane", a_bits=4, w_bits=4, ste=False)
    y_t, s_t = tcl.cim_matmul(x, w, tcl.CiMConfig(**cfg), return_stats=True)
    y_j, s_j = jcl.cim_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jcl.CiMConfig(**cfg), return_stats=True)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))
    # int8_dot is ported: equal to the JAX package's (run eagerly), stats zeros
    cfg = dict(mode="int8_dot", ste=False)
    y_t, s_t = tcl.cim_matmul(x, w, tcl.CiMConfig(**cfg), return_stats=True)
    y_j = jcl.cim_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jcl.CiMConfig(**cfg))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert (int(s_t.conversions), int(s_t.comparisons)) == (0, 0)
    # an ADC noise key draws what the JAX package draws (bitplane) or is
    # ignored (fake_quant), as in the JAX package
    noisy = dict(cfg, comparator_sigma=0.02, ref_mismatch_sigma=0.01)
    key = jax.random.PRNGKey(0)
    y_t = tcl.cim_matmul(x, w, tcl.CiMConfig(**noisy), key=key)
    y_j = jcl.cim_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jcl.CiMConfig(**noisy), key=key)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    fq = tcl.CiMConfig(mode="fake_quant")
    torch.testing.assert_close(tcl.cim_matmul(x, w, fq, key=key), tcl.cim_matmul(x, w, fq), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tcl.CiMConfig(mode="analog")


@pytest.mark.parametrize(
    "kw",
    [
        dict(rows=16, adc_bits=5),  # the chip: 16-row arrays, 5-bit SAR, 8/8 bits
        dict(rows=64, adc_bits=5, a_bits=4, w_bits=4),  # lossy: 2^B < rows
        dict(rows=16, adc_bits=5, a_bits=4, w_bits=4, search="sar_asym"),
        dict(rows=32, adc_bits=4, a_bits=4, w_bits=4, exact_counts=True),
        dict(rows=16, adc_bits=5, a_bits=4, w_bits=4, a_signed=False),
        dict(rows=10, adc_bits=5, a_bits=3, w_bits=5),  # rows not a power of two; K padded
    ],
    ids=["chip", "rows64", "sar_asym", "exact_counts", "unsigned", "rows10"],
)
def test_cim_matmul_bitplane_matches_jax(kw):
    """The faithful bit-plane mode, noiseless: outputs and digitization stats
    bit-exact against the JAX package's ``cim_matmul`` run eagerly."""
    x = _normal((2, 3, 100), 27)
    if kw.get("a_signed") is False:
        x = np.abs(x)
    w = (_normal((100, 24), 28) / 10).astype(np.float32)
    cfg = dict(mode="bitplane", ste=False, **kw)
    y_t, s_t = tcl.cim_matmul(_t(x), _t(w), tcl.CiMConfig(**cfg), return_stats=True)
    y_j, s_j = jcl.cim_matmul(jnp.asarray(x), jnp.asarray(w), jcl.CiMConfig(**cfg), return_stats=True)
    assert y_t.shape == (2, 3, 24)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert s_t.conversions.dtype == s_t.comparisons.dtype == torch.int32
    assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))


def test_cim_matmul_bitplane_ste_and_config_helpers():
    """ste=True: the bit-plane forward, the plain matmul's gradient; the ADC
    config, search tree and analytic digitization stats equal the JAX
    package's."""
    x = _t(_normal((4, 48), 29)).requires_grad_()
    w = _t(_normal((48, 8), 30))
    y = tcl.cim_matmul(x, w, tcl.CiMConfig(mode="bitplane", a_bits=4, w_bits=4, ste=True))
    y_ref = tcl.cim_matmul(x.detach(), w, tcl.CiMConfig(mode="bitplane", a_bits=4, w_bits=4, ste=False))
    torch.testing.assert_close(y.detach(), y_ref, rtol=0, atol=1e-6)
    y.sum().backward()
    torch.testing.assert_close(x.grad, w.sum(dim=1).expand(4, 48))
    for kw in (dict(), dict(search="sar_asym"), dict(rows=64, adc_bits=7, a_bits=3), dict(adc_bits=6, comparator_sigma=0.01)):
        ct, cj = tcl.CiMConfig(**kw), jcl.CiMConfig(**kw)
        assert dataclasses.asdict(ct.adc_config()) == dataclasses.asdict(cj.adc_config())
        tt, tj = ct.search_tree(), cj.search_tree()
        for field in ("threshold", "left", "right", "depth"):
            np.testing.assert_array_equal(getattr(tt, field), getattr(tj, field))
        for mkn in ((2, 32, 4), (32, 576, 1536), (1, 100, 7)):
            assert tcl.digitization_stats(ct, *mkn) == jcl.digitization_stats(cj, *mkn)


def test_cim_matmul_ste_gradient_is_linear():
    """ste=True: the forward is quantized, the gradient is the plain matmul's."""
    x = _t(_normal((4, 32), 15)).requires_grad_()
    w = _t(_normal((32, 8), 16))
    tcl.cim_matmul(x, w, tcl.CiMConfig(ste=True)).sum().backward()
    torch.testing.assert_close(x.grad, w.sum(dim=1).expand(4, 32))


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------


def _qkv(b, h, kv, sq, sk, hd, seed):
    return _normal((b, h, sq, hd), seed), _normal((b, kv, sk, hd), seed + 1), _normal((b, kv, sk, hd), seed + 2)


@pytest.mark.parametrize(
    "b,h,kv,sq,sk,hd,causal",
    [
        (2, 4, 2, 256, 256, 64, True),  # GQA g=2
        (1, 8, 8, 128, 384, 32, True),  # MHA, rectangular
        (2, 4, 1, 256, 256, 64, False),  # MQA, full attention
        (1, 2, 2, 512, 512, 128, True),  # head dim 128
    ],
)
def test_flash_plain_vs_jax_ref(b, h, kv, sq, sk, hd, causal):
    q, k, v = _qkv(b, h, kv, sq, sk, hd, 20)
    o_t = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    o_j = np.asarray(j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=1e-5)
    o_r = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(o_r, o_j, atol=1e-5, rtol=1e-5)


def test_flash_plain_block_partition_invariant():
    q, k, v = (_t(a) for a in _qkv(1, 2, 2, 512, 512, 64, 30))
    outs = [
        flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
        for bq, bk in ((128, 128), (256, 128), (128, 256), (512, 512))
    ]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=1e-5)


def test_flash_plain_bf16():
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(1, 4, 4, 256, 256, 64, 40))
    o_t = flash_attention(q, k, v, causal=True)
    assert o_t.dtype == torch.bfloat16
    f32 = lambda a: jnp.asarray(a.float().numpy())
    o_j = np.asarray(j_flash_ref(f32(q), f32(k), f32(v), causal=True))
    np.testing.assert_allclose(o_t.float().numpy(), o_j, atol=2e-2, rtol=2e-2)


def test_flash_absolute_q_positions_match_sliced_reference():
    """A query shard with absolute positions masks as rows of the full run."""
    q, k, v = _qkv(2, 6, 3, 384, 384, 64, 50)
    rows = slice(128, 256)
    pos = torch.arange(128, 256, dtype=torch.int32)
    o_t = flash_attention(_t(q[:, :, rows]), _t(k), _t(v), pos, causal=True).numpy()
    o_j = np.asarray(j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))[:, :, rows]
    np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=1e-5)


def test_flash_rejects_bad_shapes():
    q, k = torch.zeros((1, 3, 128, 32)), torch.zeros((1, 2, 128, 32))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="block"):
        flash_attention(torch.zeros((1, 2, 100, 32)), torch.zeros((1, 2, 100, 32)), torch.zeros((1, 2, 100, 32)))
