"""PyTorch port vs ``jax.random``: the threefry PRNG, on the CPU, bit for bit.

Every draw of ``repro_torch.core.prng`` must equal jax 0.9.0's (partitionable
threefry, the installed setting) with no tolerance: key data, ``split``,
``fold_in`` (scalars and per-row vectors), 32-bit ``bits``, ``uniform`` with
default and custom bounds, and ``normal`` (XLA's erf_inv as compiled for the
CPU), including 2^20 normal draws, which reach the tails and both sides of
the |y| = sqrt(2) - 1 branch of its log1p.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng


def _j(key_t: torch.Tensor):
    """The port's key data as a JAX uint32 key."""
    return jnp.asarray(key_t.numpy().astype(np.uint32))


def _same_bits(a_t: torch.Tensor, a_j):
    a_j = np.asarray(a_j)
    assert tuple(a_t.shape) == a_j.shape
    if a_j.dtype == np.float32:
        assert a_t.dtype == torch.float32
        np.testing.assert_array_equal(a_t.numpy().view(np.uint32), a_j.view(np.uint32))
    else:
        np.testing.assert_array_equal(a_t.numpy(), a_j.astype(np.int64))


def test_threefry_partitionable_is_the_reference_setting():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**32 + 7, -5])
def test_prng_key_matches_jax(seed):
    _same_bits(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(num):
    for seed in (0, 2**31 - 1):
        _same_bits(prng.split(prng.PRNGKey(seed), num), jax.random.split(jax.random.PRNGKey(seed), num))
    # a batch of keys maps like vmap
    keys = prng.split(prng.PRNGKey(9), 4)
    _same_bits(prng.split(keys, num), jax.vmap(lambda k: jax.random.split(k, num))(_j(keys)))


def test_fold_in_matches_jax():
    key = prng.PRNGKey(3)
    for data in (0, 1, 5, 2**31 - 1, 2**32 - 1):
        _same_bits(prng.fold_in(key, data), jax.random.fold_in(jax.random.PRNGKey(3), data))
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(3), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(key, -1)
    # per-row keys as the bit-plane ADC folds them: int32 global row ids,
    # wrapping past 2^31 as jnp's int32 arithmetic wraps
    ids = (np.int32(2**31 - 5) + np.arange(4096, dtype=np.int32)).astype(np.int32)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(3), jnp.asarray(ids))
    _same_bits(prng.fold_in(key, torch.from_numpy(ids)), want)
    # fold a batch of keys with one datum each
    keys = prng.split(key, 5)
    _same_bits(prng.fold_in(keys, 11), jax.vmap(lambda k: jax.random.fold_in(k, 11))(_j(keys)))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (2, 3, 5)])
def test_bits_and_uniform_match_jax(shape):
    key = prng.PRNGKey(7)
    kj = jax.random.PRNGKey(7)
    _same_bits(prng.bits(key, shape), jax.random.bits(kj, shape))
    _same_bits(prng.uniform(key, shape), jax.random.uniform(kj, shape))
    _same_bits(prng.normal(key, shape), jax.random.normal(kj, shape))


@pytest.mark.parametrize("bounds", [(-0.5, 0.7), (2.0, 3.3), (-1e-3, 5.0), (-1.0, 1.0)])
def test_uniform_custom_bounds_match_jax(bounds):
    """The scale and shift is one fused multiply-add in XLA's kernel."""
    n = 1 << 16
    lo, hi = bounds
    _same_bits(prng.uniform(prng.PRNGKey(11), (n,), lo, hi),
               jax.random.uniform(jax.random.PRNGKey(11), (n,), minval=lo, maxval=hi))


@functools.lru_cache(maxsize=None)
def _normal_2_20(seed):
    """2^20 normal draws of ``PRNGKey(seed)``, made once per module by each
    package: (the port's, jax.random's)."""
    n = 1 << 20
    return prng.normal(prng.PRNGKey(seed), (n,)), np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))


@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_normal_2_20_draws_bit_exact(seed):
    got, want = _normal_2_20(seed)
    _same_bits(got, want)
    u = np.abs(want / np.sqrt(2, dtype=np.float32))
    # the draws reach both log1p branches (|y| = u^2 about sqrt(2) - 1) and the far tail
    assert (u * u < 0.41421357).any() and (u * u >= 0.41421357).any() and np.abs(want).max() > 4.5


def test_normal_with_a_batch_of_keys_matches_vmap():
    keys = prng.fold_in(prng.PRNGKey(5), torch.arange(6, dtype=torch.int32))
    want = jax.vmap(lambda k: jax.random.normal(k, (3, 17)))(_j(keys))
    _same_bits(prng.normal(keys, (3, 17)), want)
    # normal_at draws a slice of a larger draw: rows 1..2 of (3, 17)
    index = torch.arange(17, 51, dtype=torch.int64).reshape(2, 17)
    _same_bits(prng.normal_at(keys, index), np.asarray(want)[:, 1:])


def test_keys_in_every_form():
    """JAX key arrays, numpy uint32 and the port's int64 keys are one key."""
    k = jax.random.PRNGKey(4)
    for form in (k, np.asarray(k), prng.PRNGKey(4), [0, 4]):
        _same_bits(prng.normal(form, (4,)), jax.random.normal(k, (4,)))
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        prng.as_key(torch.zeros(3, dtype=torch.int64))


def test_fused_multiply_add_is_exact():
    """``_fma`` rounds a * b + c once: against float64 with an exact check
    where the double rounding of a plain float64 sum would err."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1 << 16).astype(np.float32)
    b = rng.standard_normal(1 << 16).astype(np.float32)
    c = rng.standard_normal(1 << 16).astype(np.float32)
    got = prng._fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    from fractions import Fraction

    for i in range(0, 1 << 16, 997):  # exact rational reference on a sample
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(-np.inf)), np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best
    # (1 + 2^-23) * 2^-24 (1 - 2^-23) + (1 + 2^-23) lies 2^-70 below a float32
    # tie; a plain float64 sum rounds onto the tie and then to even (up), the
    # fused multiply-add rounds down
    f = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    a, b, c = f(1 + 2.0**-23), f(2.0**-24 * (1 - 2.0**-23)), f(1 + 2.0**-23)
    plain = (a.double() * b.double() + c.double()).float()
    assert plain.item() == 1 + 2.0**-22
    assert prng._fma(a, b, c).item() == 1 + 2.0**-23


def test_the_contractions_are_the_ones_xla_makes(monkeypatch):
    """The choices the port copies from XLA's compiled kernels matter: the
    other fused pair in log1p's ``y^2 * -0.5 + y^3 * R``, or an unfused
    scale and shift in ``uniform``, part from ``jax.random``."""
    n = 1 << 20
    key, kj = prng.PRNGKey(0), jax.random.PRNGKey(0)

    def other_pair(y):
        p, q = torch.ones_like(y), torch.full_like(y, prng._f32(0x383DE04B))
        for c in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982):
            p = prng._fma(p, y, prng._f32(c))
        for c in (0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD, 0x41A05101):
            q = prng._fma(q, y, prng._f32(c))
        y2 = y * y
        return y + prng._fma(y * y2, prng._div(q, p), y2 * -0.5)

    got, want = _normal_2_20(0)
    _same_bits(got, want)
    with monkeypatch.context() as m:
        m.setattr(prng, "_log1p_small", other_pair)
        assert (prng.normal(key, (n,)).numpy() != want).sum() > 0
    lo, hi = np.float32(-0.5), np.float32(0.7)
    unfused = torch.clamp(prng._unit_floats(prng.bits(key, (n,))) * torch.tensor(hi - lo) + float(lo), min=float(lo))
    assert (unfused.numpy() != np.asarray(jax.random.uniform(kj, (n,), minval=lo, maxval=hi))).mean() > 0.1
