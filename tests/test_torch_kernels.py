"""PyTorch port vs JAX package: the kernels' plain versions, the oracles and
the CiM matmul, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX Pallas fake-quant kernel runs in interpret mode; the JAX flash kernel
does not run on this jax version, so the port's attention is held against
``repro.kernels.ref.flash_attention_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_linear as jcl
from repro.core.cim_array import bit_planes as j_bit_planes
from repro.kernels import ref as jref
from repro.kernels.cim_matmul import cim_matmul_pallas
from repro.kernels.ops import cim_matmul_op as j_cim_matmul_op
from repro_torch.core import cim_linear as tcl
from repro_torch.core.cim_array import bit_planes, plane_weights
from repro_torch.kernels import ref as tref
from repro_torch.kernels.cim_matmul import cim_matmul_fq
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import cim_matmul_op

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


@pytest.mark.parametrize("bits,signed,per_axis", [(8, True, None), (8, True, -1), (4, False, 0)])
def test_quantize_symmetric_bit_exact(bits, signed, per_axis):
    x = _normal((33, 40), 1) * 3.0
    xi_t, s_t = tcl.quantize_symmetric(_t(x), bits, signed, per_axis=per_axis)
    xi_j, s_j = jcl.quantize_symmetric(jnp.asarray(x), bits, signed, per_axis=per_axis)
    np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


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


def test_adc_quant_oracle_matches_jax():
    v = np.random.default_rng(8).uniform(-0.2, 1.2, (16, 40)).astype(np.float32)
    for bits in (3, 5):
        np.testing.assert_array_equal(
            tref.adc_quant_ref(_t(v), bits).numpy(), np.asarray(jref.adc_quant_ref(jnp.asarray(v), bits))
        )


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
    for mode in ("bitplane", "int8_dot"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcl.cim_matmul(x, w, tcl.CiMConfig(mode=mode))
    with pytest.raises(ValueError):
        tcl.CiMConfig(mode="analog")


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
