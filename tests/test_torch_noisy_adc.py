"""PyTorch port vs JAX package: the noisy memory-immersed ADC, the noisy
bit-plane CiM matmul and the CiM array's MAV noise, on the CPU, bit for bit.

The same numpy inputs and the same ``jax.random`` keys go to both packages
(the port reads JAX key data as its own). Codes, comparisons, cycles,
ladders, transfer curves, DNL/INL, matmul outputs and stats must be equal,
with no tolerance: a code at a comparator threshold flips on a one-ulp
difference of its noise draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import cim_array as jca
from repro.core import cim_linear as jcl
from repro.core import mav_stats as jms
from repro.core import search_tree as jst
from repro_torch.core import adc as tadc
from repro_torch.core import cim_array as tca
from repro_torch.core import cim_linear as tcl
from repro_torch.core import prng
from repro_torch.core import search_tree as tst

KEY = jax.random.PRNGKey(3)
MODES = ["sar", "sar_asym", "flash", "hybrid", "ideal"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(res_j, res_t, what=""):
    for name, a, b in zip(("codes", "comparisons", "cycles"), res_j, res_t):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{what} {name}")


def _mavs(shape, seed):
    """MAV-like voltages: 16-row levels with the half-LSB bias (each sits
    within noise of its code boundaries) and uniform values past [0, 1)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    levels = rng.binomial(16, 0.3, n // 2) / 16.0 + 0.5 / 32
    return np.concatenate([levels, rng.uniform(-0.05, 1.05, n - n // 2)]).astype(np.float32).reshape(shape)


def _trees(mode, bits=5, rows=16):
    if mode != "sar_asym":
        return None, None
    pmf = jms.analytic_code_pmf(rows, bits)
    return jst.optimal_tree(pmf), tst.optimal_tree(np.asarray(pmf))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sigmas", [(0.02, 0.05), (0.0, 0.1)], ids=["both", "mismatch"])
def test_noisy_convert_matches_jax(mode, sigmas):
    kw = dict(mode=mode, comparator_sigma=sigmas[0], ref_mismatch_sigma=sigmas[1])
    cj, ct = jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)
    v = _mavs((4, 6, 50), 1)
    tj, tt = _trees(mode)
    res_j = jadc.convert(jnp.asarray(v), cj, key=KEY, tree=tj)
    res_t = tadc.convert(_t(v), ct, key=KEY, tree=tt)
    _same(res_j, res_t, mode)
    if sigmas[0] > 0 and mode != "ideal":  # the noise moved codes off the noiseless walk
        quiet = tadc.convert(_t(v), dataclasses.replace(ct, comparator_sigma=0.0, ref_mismatch_sigma=0.0), tree=tt)
        assert (res_t.codes != quiet.codes).any()


def test_noisy_hybrid_with_fine_trees_and_more_bits_matches_jax():
    kw = dict(mode="hybrid", bits=6, flash_bits=2, n_ref_columns=100, comparator_sigma=0.01, ref_mismatch_sigma=0.03)
    cj, ct = jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)
    pmf = np.full(16, 1 / 16)
    pmf[:4] *= 3
    pmf /= pmf.sum()
    fine_j = [jst.optimal_tree(np.roll(pmf, s)) for s in range(4)]
    fine_t = [tst.optimal_tree(np.roll(pmf, s)) for s in range(4)]
    v = _mavs((3000,), 2)
    _same(jadc.convert(jnp.asarray(v), cj, key=KEY, fine_trees=fine_j),
          tadc.convert(_t(v), ct, key=KEY, fine_trees=fine_t))


@pytest.mark.parametrize("n_cols,bits", [(32, 5), (64, 6), (100, 5), (16, 4)])
def test_mismatch_ladder_matches_jax(n_cols, bits):
    """The unit caps' running sum follows XLA's blocked cumsum order (blocks
    of 16); a left-to-right float32 sum parts from it."""
    kw = dict(bits=bits, n_ref_columns=n_cols, ref_mismatch_sigma=0.08)
    cj, ct = jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(tadc.make_reference_ladder(ct, k).numpy(),
                                      np.asarray(jadc.make_reference_ladder(cj, k)))


def test_xla_cumsum_order_matches_jax():
    for n in (1, 15, 16, 17, 33, 255, 300, 1000):
        x = (1 + 0.05 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
        np.testing.assert_array_equal(tadc._xla_cumsum(_t(x)).numpy(), np.asarray(jnp.cumsum(jnp.asarray(x))))


@pytest.mark.parametrize("mode", ["sar", "flash", "hybrid"])
def test_measure_transfer_and_dnl_inl_with_a_key_match_jax(mode):
    kw = dict(mode=mode, comparator_sigma=0.002, ref_mismatch_sigma=0.05)
    cj, ct = jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)
    ramp_j, codes_j = jadc.measure_transfer(cj, key=KEY, n_points=4096)
    ramp_t, codes_t = tadc.measure_transfer(ct, key=KEY, n_points=4096, device="cpu")
    np.testing.assert_array_equal(ramp_t, ramp_j)
    np.testing.assert_array_equal(codes_t, codes_j)
    for a, b in zip(jadc.dnl_inl(ramp_j, codes_j, cj), tadc.dnl_inl(ramp_t, codes_t, ct)):
        np.testing.assert_array_equal(b, a)


def test_convert_over_a_key_axis_equals_jax_vmap():
    """One key per index of an axis equals ``jax.vmap`` of ``convert`` over
    it with a shared ladder (the per-row noise of the bit-plane matmul; its
    SAR walk over a key axis is held to JAX by the matmul tests below, the
    flash bank's here inside the hybrid front-end)."""
    v = _mavs((3, 5, 4, 7), 3)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(KEY, jnp.arange(10, 15, dtype=jnp.int32))
    for mode in ("hybrid",):
        kw = dict(mode=mode, comparator_sigma=0.03, ref_mismatch_sigma=0.02)
        cj, ct = jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)
        ladder = jadc.make_reference_ladder(cj, KEY)
        res_j = jax.vmap(lambda vr, kr: jadc.convert(vr, cj, key=kr, ladder=ladder), in_axes=(1, 0), out_axes=1)(
            jnp.asarray(v), keys)
        res_t = tadc.convert(_t(v), ct, key=np.asarray(keys), ladder=_t(ladder), key_axis=1)
        _same(res_j, res_t, mode)
    with pytest.raises(ValueError, match="shared ladder"):
        tadc.convert(_t(v), ct, key=np.asarray(keys), key_axis=1)
    with pytest.raises(ValueError, match="key of shape"):
        tadc.convert(_t(v), ct, key=np.asarray(keys)[:3], ladder=_t(ladder), key_axis=1)


BP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, ste=False,
          comparator_sigma=0.03, ref_mismatch_sigma=0.02)


@pytest.mark.parametrize(
    "kw",
    [BP, dict(BP, search="sar_asym", a_signed=False), dict(BP, a_bits=3, w_bits=5, rows=10, exact_counts=True)],
    ids=["chip", "sar_asym_unsigned", "rows10"],
)
def test_noisy_bitplane_matmul_with_row_offset_matches_jax(kw):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    if kw.get("a_signed") is False:
        x = np.abs(x)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    cj, ct = jcl.CiMConfig(**kw), tcl.CiMConfig(**kw)
    xi, _ = jcl.quantize_symmetric(jnp.asarray(x), cj.a_bits, cj.a_signed)
    wi, _ = jcl.quantize_symmetric(jnp.asarray(w), cj.w_bits, cj.w_signed, per_axis=-1)
    for row_offset in (7, 2**31 - 3):
        y_j, s_j = jcl._bitplane_matmul(xi, wi, cj, KEY, row_offset=row_offset)
        y_t, s_t = tcl._bitplane_matmul(_t(xi), _t(wi), ct, KEY, row_offset=row_offset)
        np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
        assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))
    # a row's draws depend on its global index only: rows 2.. at offset 2 are rows 2.. at offset 0
    y0, _ = tcl._bitplane_matmul(_t(xi), _t(wi), ct, KEY, row_offset=0)
    y2, _ = tcl._bitplane_matmul(_t(xi)[2:], _t(wi), ct, KEY, row_offset=2)
    np.testing.assert_array_equal(y2.numpy(), y0[2:].numpy())


def test_noisy_cim_matmul_and_cim_linear_match_jax():
    rng = np.random.default_rng(6)  # the shapes of the matmul tests above (JAX compiles once)
    x = rng.standard_normal((5, 1, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) / 7).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    cj, ct = jcl.CiMConfig(**BP), tcl.CiMConfig(**BP)
    y_j, s_j = jcl.cim_matmul(jnp.asarray(x), jnp.asarray(w), cj, key=KEY, return_stats=True)
    y_t, s_t = tcl.cim_matmul(_t(x), _t(w), ct, key=prng.as_key(KEY), return_stats=True)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert (int(s_t.conversions), int(s_t.comparisons)) == (int(s_j.conversions), int(s_j.comparisons))
    np.testing.assert_array_equal(
        tcl.cim_linear(_t(x), _t(w), _t(b), ct, key=KEY).numpy(),
        np.asarray(jcl.cim_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), cj, key=KEY)),
    )


def test_cim_array_model_mav_noise_matches_jax():
    rng = np.random.default_rng(7)
    xb = (rng.uniform(size=(3, 5, 16)) > 0.5).astype(np.int32)
    wb = (rng.uniform(size=(16, 32)) > 0.4).astype(np.int32)
    for kw in (dict(mav_sigma=0.01), dict(mav_sigma=0.003, vdd=0.9), dict()):
        mj, mt = jca.CiMArrayModel(**kw), tca.CiMArrayModel(**kw)
        want = np.asarray(mj.compute_mav(jnp.asarray(xb), jnp.asarray(wb), KEY))
        got = mt.compute_mav(_t(xb), _t(wb), KEY)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="PRNG key"):
        tca.CiMArrayModel(mav_sigma=0.01).compute_mav(_t(xb), _t(wb))
    with pytest.raises(ValueError, match="shape mismatch"):
        tca.CiMArrayModel(rows=8).compute_mav(_t(xb), _t(wb))
