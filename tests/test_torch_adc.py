"""PyTorch port vs JAX package: the memory-immersed ADC, its search trees and
the MAV statistics, on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
converters here are noiseless (the noisy ones are in
``test_torch_noisy_adc.py``), and codes, comparisons and cycles must be equal
element for element; the search trees' tables must be equal array for array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as jadc
from repro.core import mav_stats as jms
from repro.core import search_tree as jst
from repro.core.scipy_free_stats import binom_pmf as j_binom_pmf
from repro_torch.core import adc as tadc
from repro_torch.core import mav_stats as tms
from repro_torch.core import search_tree as tst
from repro_torch.core.scipy_free_stats import binom_pmf


def _cfgs(**kw):
    return jadc.ADCConfig(**kw), tadc.ADCConfig(**kw)


def _ramp():
    return np.linspace(0.0, 0.999, 4096).astype(np.float32)


def _mavs(seed=0):
    """Random MAV-like voltages: Binomial(16, 1/4) levels with the half-LSB
    bias, plus uniform values over and past [0, 1)."""
    rng = np.random.default_rng(seed)
    levels = rng.binomial(16, 0.25, 3000) / 16.0 + 0.5 / 32
    return np.concatenate([levels, rng.uniform(-0.1, 1.1, 3000)]).astype(np.float32)


def _assert_same_result(res_j, res_t):
    for name, a, b in zip(("codes", "comparisons", "cycles"), res_j, res_t):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _assert_same_tree(tj, tt):
    for field in ("threshold", "left", "right", "depth"):
        a, b = getattr(tj, field), getattr(tt, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    assert tt.n_codes == tj.n_codes and tt.max_depth == tj.max_depth


# ---------------------------------------------------------------------------
# statistics and search trees (pure numpy copies)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p", [(16, 0.25), (64, 0.1), (5, 0.0), (5, 1.0)])
def test_binom_and_mav_stats_match_jax(n, p):
    np.testing.assert_array_equal(binom_pmf(n, p), j_binom_pmf(n, p))
    np.testing.assert_array_equal(tms.analytic_mav_pmf(n, p), jms.analytic_mav_pmf(n, p))
    for bits in (3, 5):
        np.testing.assert_array_equal(tms.analytic_code_pmf(n, bits, p), jms.analytic_code_pmf(n, bits, p))
        samples = np.random.default_rng(n).uniform(-0.1, 1.1, 500)
        np.testing.assert_array_equal(tms.empirical_code_pmf(samples, bits), jms.empirical_code_pmf(samples, bits))
    pmf = tms.analytic_code_pmf(16, 5)
    assert tms.entropy_bits(pmf) == jms.entropy_bits(pmf)
    with pytest.raises(ValueError):
        binom_pmf(4, 1.5)


@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_search_tree_tables_match_jax(bits):
    pmf = jms.analytic_code_pmf(16, bits)
    for build in ("symmetric_tree", "optimal_tree", "weight_balanced_tree"):
        arg = bits if build == "symmetric_tree" else pmf
        tj, tt = getattr(jst, build)(arg), getattr(tst, build)(arg)
        _assert_same_tree(tj, tt)
        tst.validate_tree(tt)
        assert tst.expected_comparisons(tt, pmf) == jst.expected_comparisons(tj, pmf)
    # a skewed random pmf and the degenerate one-code tree
    rand = np.random.default_rng(bits).dirichlet(np.ones(1 << bits) * 0.3)
    _assert_same_tree(jst.optimal_tree(rand), tst.optimal_tree(rand))
    _assert_same_tree(jst.optimal_tree(np.ones(1)), tst.optimal_tree(np.ones(1)))


def test_validate_tree_rejects_a_broken_tree():
    tree = tst.symmetric_tree(3)
    bad = tst.TreeTables(tree.threshold[::-1].copy(), tree.left, tree.right, tree.depth, tree.n_codes)
    with pytest.raises(AssertionError):
        tst.validate_tree(bad)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [3, 5, 6])
@pytest.mark.parametrize("mode", ["sar", "flash", "ideal"])
def test_convert_matches_jax(mode, bits):
    cj, ct = _cfgs(bits=bits, mode=mode, n_ref_columns=max(32, 1 << bits))
    for v in (_ramp(), _mavs(bits)):
        _assert_same_result(jadc.convert(jnp.asarray(v), cj), tadc.convert(torch.from_numpy(v), ct))


@pytest.mark.parametrize("mode", ["sar", "sar_asym"])
def test_convert_asymmetric_tree_matches_jax(mode):
    """An asymmetric tree changes the comparison counts, not the codes; both
    must equal the JAX package's (``sar`` takes a given tree as well)."""
    pmf = jms.analytic_code_pmf(16, 5)
    cj, ct = _cfgs(bits=5, mode=mode)
    tj, tt = jst.optimal_tree(pmf), tst.optimal_tree(pmf)
    for v in (_ramp(), _mavs(1)):
        res_t = tadc.convert(torch.from_numpy(v), ct, tree=tt)
        _assert_same_result(jadc.convert(jnp.asarray(v), cj, tree=tj), res_t)
    # without a tree, sar_asym walks the symmetric one
    v = _mavs(2)
    _assert_same_result(jadc.convert(jnp.asarray(v), cj), tadc.convert(torch.from_numpy(v), ct))


@pytest.mark.parametrize("flash_bits", [1, 2, 3])
def test_convert_hybrid_matches_jax(flash_bits):
    cj, ct = _cfgs(bits=5, mode="hybrid", flash_bits=flash_bits)
    for v in (_ramp(), _mavs(3)):
        _assert_same_result(jadc.convert(jnp.asarray(v), cj), tadc.convert(torch.from_numpy(v), ct))


def test_convert_hybrid_asymmetric_fine_trees_matches_jax():
    """Hybrid with per-segment optimal trees of different depths (the tables
    are padded and stacked): codes, comparisons and cycles equal."""
    pmf = jms.analytic_code_pmf(16, 5)
    seg = 8  # 2 flash bits -> segments of 8 codes
    parts = [pmf[s * seg : (s + 1) * seg] for s in range(4)]
    fine = [p / max(p.sum(), 1e-12) for p in parts]
    fj, ft = [jst.optimal_tree(p) for p in fine], [tst.optimal_tree(p) for p in fine]
    assert len({t.max_depth for t in ft}) > 1  # asymmetric: segments differ in depth
    for a, b in zip(jadc.stack_trees(fj), tadc.stack_trees(ft)):
        np.testing.assert_array_equal(b.numpy() if isinstance(b, torch.Tensor) else b, np.asarray(a))
    cj, ct = _cfgs(bits=5, mode="hybrid", flash_bits=2)
    for v in (_ramp(), _mavs(4)):
        res_t = tadc.convert(torch.from_numpy(v), ct, fine_trees=ft)
        _assert_same_result(jadc.convert(jnp.asarray(v), cj, fine_trees=fj), res_t)
    with pytest.raises(ValueError, match="fine trees"):
        tadc.convert(torch.from_numpy(_ramp()), ct, fine_trees=ft[:3])


def test_convert_takes_a_given_ladder_and_any_shape():
    cj, ct = _cfgs(bits=4, mode="sar")
    ladder = np.sort(np.random.default_rng(5).uniform(0, 1, 17)).astype(np.float32)
    v = _mavs(5)[:600].reshape(2, 3, 100)
    res_j = jadc.convert(jnp.asarray(v), cj, ladder=jnp.asarray(ladder))
    res_t = tadc.convert(torch.from_numpy(v), ct, ladder=torch.from_numpy(ladder))
    assert res_t.codes.shape == (2, 3, 100)
    _assert_same_result(res_j, res_t)


# ---------------------------------------------------------------------------
# ladder, ideal quantizer, static characterization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,vdd,n_ref", [(5, 1.0, 32), (3, 0.8, 32), (6, 1.0, 64), (5, 0.9, 40)])
def test_ladder_quantizer_and_transfer_match_jax(bits, vdd, n_ref):
    cj, ct = _cfgs(bits=bits, vdd=vdd, n_ref_columns=n_ref, mode="sar")
    np.testing.assert_array_equal(
        tadc.make_reference_ladder(ct).numpy(), np.asarray(jadc.make_reference_ladder(cj))
    )
    v = _mavs(bits)
    codes_j = jadc.quantize_ideal(jnp.asarray(v), bits, vdd)
    codes_t = tadc.quantize_ideal(torch.from_numpy(v), bits, vdd)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(
        tadc.dequantize(codes_t, bits, vdd).numpy(), np.asarray(jadc.dequantize(codes_j, bits, vdd))
    )
    ramp_j, st_j = jadc.measure_transfer(cj, n_points=4096)
    ramp_t, st_t = tadc.measure_transfer(ct, n_points=4096, device="cpu")
    np.testing.assert_array_equal(ramp_t, ramp_j)
    np.testing.assert_array_equal(st_t, st_j)
    for a, b in zip(jadc.dnl_inl(ramp_j, st_j, cj), tadc.dnl_inl(ramp_t, st_t, ct)):
        np.testing.assert_array_equal(b, a)


def test_dnl_inl_zero_without_mismatch():
    cfg = tadc.ADCConfig(bits=5, mode="sar")
    r, codes = tadc.measure_transfer(cfg, n_points=1 << 14, device="cpu")
    dnl, inl = tadc.dnl_inl(r, codes, cfg)
    assert np.nanmax(np.abs(dnl)) < 0.05 and np.nanmax(np.abs(inl)) < 0.05
    assert (np.diff(codes) >= 0).all()


# ---------------------------------------------------------------------------
# configuration and the keys of the noisy paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw", [dict(mode="pipelined"), dict(bits=6, n_ref_columns=32), dict(mode="hybrid", flash_bits=5)]
)
def test_adc_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jadc.ADCConfig(**kw)
    with pytest.raises(ValueError):
        tadc.ADCConfig(**kw)


@pytest.mark.parametrize("mode", ["sar", "sar_asym", "flash", "hybrid", "ideal"])
def test_keys_raise_naming_the_prng_queue(mode):
    """The PRNG queue (A1) is done: a JAX key no longer raises, and the
    noisy conversion, ladder and transfer equal the JAX package's."""
    cj, ct = _cfgs(mode=mode, comparator_sigma=0.01, ref_mismatch_sigma=0.02)
    v = _ramp()
    _assert_same_result(jadc.convert(jnp.asarray(v), cj, key=jax.random.PRNGKey(0)),
                        tadc.convert(torch.from_numpy(v), ct, key=jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(
        tadc.make_reference_ladder(ct, key=np.array([0, 1], np.uint32)).numpy(),
        np.asarray(jadc.make_reference_ladder(cj, key=jnp.array([0, 1], jnp.uint32))),
    )
    for a, b in zip(jadc.measure_transfer(cj, key=jax.random.PRNGKey(1)),
                    tadc.measure_transfer(ct, key=jax.random.PRNGKey(1), device="cpu")):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("mode", ["sar", "flash", "hybrid"])
def test_comparator_noise_without_a_key_raises(mode):
    cj, ct = _cfgs(mode=mode, comparator_sigma=0.01)
    v = _ramp()
    if mode != "hybrid":  # the JAX hybrid front-end fails inside jax.random instead
        with pytest.raises(ValueError, match="PRNG key"):
            jadc.convert(jnp.asarray(v), cj)
    with pytest.raises(ValueError, match="PRNG key"):
        tadc.convert(torch.from_numpy(v), ct)
    # ideal mode and a zero sigma never draw: equal to JAX
    cj0, ct0 = _cfgs(mode=mode)
    _assert_same_result(jadc.convert(jnp.asarray(v), cj0), tadc.convert(torch.from_numpy(v), ct0))
