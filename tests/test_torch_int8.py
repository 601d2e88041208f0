"""PyTorch port vs JAX package: the ``int8_dot`` CiM mode, on the CPU.

``int8_dot`` quantizes the activation per tensor and the weight per output
column to 8 bits and takes the s8 x s8 -> s32 product (``torch._int_mm``,
JAX's ``dot_general`` with an int32 result). The quantized output equals
eager JAX's bit for bit on random inputs. With the STE the value is
``y_lin + (y_q - y_lin)`` and the gradient that of the float product
``x @ w``, whose float32 sums torch and XLA order differently: on inputs of a
dyadic grid (every product and partial sum exact in float32) the STE value
and the gradient equal JAX's bit for bit; on random inputs they agree within
2 ulp of their scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import cim_linear as jcl
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config, reduced
from repro_torch.core import cim_linear as tcl
from repro_torch.models import build_model
from repro_torch.models.weights import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(m, k, n, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:  # multiples of 1/8 and 1/64 below 2: products and sums exact in float32 (and bf16 x)
        x = rng.integers(-15, 16, (m, k)).astype(np.float32) / 8
        w = rng.integers(-63, 64, (k, n)).astype(np.float32) / 64
        g = rng.integers(-7, 8, (m, n)).astype(np.float32) / 4
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, g


def _both(x, w, g, dtype, ste):
    """(JAX's y, dx, dw; the port's y, dx, dw) of int8_dot as float32 numpy."""
    tdt, jdt = DTYPES[dtype]
    f = lambda a, b: jcl.cim_matmul(a, b, jcl.CiMConfig(mode="int8_dot", ste=ste))  # noqa: E731
    yj, vjp = jax.vjp(f, jnp.asarray(x).astype(jdt), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g).astype(yj.dtype))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = tcl.cim_matmul(xt, wt, tcl.CiMConfig(mode="int8_dot", ste=ste))
    yt.backward(torch.from_numpy(g).to(yt.dtype))
    assert yt.dtype == tdt and str(yj.dtype) == dtype
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    return (as_np(yj), as_np(gx), as_np(gw)), tuple(t.detach().float().numpy() for t in (yt, xt.grad, wt.grad))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", [4, 17, 64])
def test_int8_dot_output_bit_exact(m, dtype):
    """ste=False: the quantized product and its cast to x's dtype."""
    x, w, g = _inputs(m, 96, 40, m, dyadic=False)
    (yj, _, _), (yt, _, _) = _both(x, w, g, dtype, ste=False)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", [4, 17, 64])
def test_int8_dot_ste_value_and_gradient_bit_exact(m, dtype):
    x, w, g = _inputs(m, 96, 40, 100 + m, dyadic=True)
    jax_out, port_out = _both(x, w, g, dtype, ste=True)
    for name, a, b in zip(("value", "dx", "dw"), port_out, jax_out):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the STE's value is the quantized product, rounded through y_lin
    (yq, _, _), _ = _both(x, w, g, dtype, ste=False)
    np.testing.assert_allclose(port_out[0], yq, rtol=0, atol=2e-2 * np.abs(yq).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_dot_ste_random_inputs_within_float_sums(dtype):
    x, w, g = _inputs(64, 96, 40, 7, dyadic=False)
    jax_out, port_out = _both(x, w, g, dtype, ste=True)
    ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    for name, a, b in zip(("value", "dx", "dw"), port_out, jax_out):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * ulp * np.abs(b).max(), err_msg=name)


def test_int8_dot_exact_in_int32_and_stats():
    """Saturated codes at the largest registered K (14336) sum exactly; the
    stats are zeros, as in the JAX package."""
    k = 14336
    x = torch.full((2, k), 1.0)
    w = torch.full((k, 8), -1.0)
    y, stats = tcl.cim_matmul(x, w, tcl.CiMConfig(mode="int8_dot", ste=False), return_stats=True)
    # codes 127 and -127, scales 1/127: y = -127^2 k / 127^2 = -k, exact
    assert torch.equal(y, torch.full((2, 8), -float(k)))
    assert int(stats.conversions) == 0 and int(stats.comparisons) == 0
    assert tcl._int8_product(x.to(torch.int8), w.to(torch.int8)).dtype == torch.int32


def test_reduced_serve_int8_dot_and_int8_kv_match_jax():
    """The reduced smollm-135m with int8_dot linears and the int8 KV cache:
    prefill and 3 decode steps, the port against the JAX model's functions
    on the same weights, logits within 1e-5 of max|logit| (4.8e-7 seen: the
    KV path quantizes softmax probabilities from torch's and XLA's exp,
    whose last bits differ and can move a code)."""
    cim = dict(mode="int8_dot", ste=False)
    cj = dataclasses.replace(j_reduced(j_get_config("smollm-135m")), cim=jcl.CiMConfig(**cim), kv_quant_int8=True)
    ct = dataclasses.replace(reduced(get_config("smollm-135m")), cim=tcl.CiMConfig(**cim), kv_quant_int8=True)
    jm, tm = j_build_model(cj), build_model(ct, "cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), ct, "cpu")
    tokens = np.random.default_rng(1).integers(0, ct.vocab, (2, 16)).astype(np.int32)
    jc, tc = jm.make_cache(2, 20), tm.make_cache(2, 20)
    assert tc["k"].dtype == torch.int8
    with torch.no_grad():
        lj, jc = jm.prefill(jp, jnp.asarray(tokens), jc)
        lt, tc = tm.prefill(tp, torch.from_numpy(tokens), tc)
        worst = 0.0
        for i in range(4):
            a, b = lt.float().numpy(), np.asarray(lj, np.float32)
            assert a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
            if i == 3:
                break
            tok = b[:, -1].argmax(-1).astype(np.int32)
            lj, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.int32(16 + i), jc)
            lt, tc = tm.decode_step(tp, torch.from_numpy(tok), 16 + i, tc)
    print(f"int8 serve: logits within {worst:.3g} of max|logit|")
    assert worst <= 1e-5, worst
