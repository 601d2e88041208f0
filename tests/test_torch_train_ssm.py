"""PyTorch port vs JAX package: the training loss and gradients of the
Mamba2 stack and the Zamba2 hybrid at a small size on the CPU.

The reduced configs chunk the SSD by 32, so the 64-token batch fills two
chunks and the state carry between them runs. The JAX params come from the
JAX init through ``params_from_jax``; the JAX side is jitted (no
quantization here, so XLA's rewrites move no code). The loss must agree
within 1e-5 of itself and every gradient leaf within 1e-5 of its largest
magnitude (float32 summation order through the SSD and the chunked loss).
The hybrid's remat (each group, the shared block with it, as one unit;
each tail layer alone) must give the bits of no remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import value_and_grad
from repro_torch.models import build_model
from repro_torch.models.weights import params_from_jax
from repro_torch.tree import leaves_with_path, path_key


@pytest.fixture(autouse=True)
def _no_act_rules():
    JL.set_act_rules(None)
    yield
    JL.set_act_rules(None)


def _batch(vocab, b=2, s=64, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:].copy()}


def _port(mt, pt, batch):
    """The trainer's own gradient entry point, grads keyed by flat path."""
    (loss, _), grads = value_and_grad(mt.loss_fn, pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), {path_key(p): g for p, g in leaves_with_path(grads)}


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_loss_and_grads_match_jax(arch):
    cj, ct = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    mj, mt = j_build_model(cj), build_model(ct, "cpu")
    pj = jax.jit(mj.init)(jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree_util.tree_map(np.array, pj), ct, "cpu")
    batch = _batch(ct.vocab)
    (lj, _), gj = jax.jit(jax.value_and_grad(mj.loss_fn, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    lt, gt = _port(mt, pt, batch)
    assert lt == pytest.approx(float(lj), rel=1e-5)
    flat_j = {path_key(tuple(str(getattr(k, "key", k)) for k in p)): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(gj)[0]}
    assert set(flat_j) == set(gt)
    for key, g in gt.items():
        want = flat_j[key]
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-5 * scale, f"{arch} grad {key}: {err:.3g} of max {scale:.3g}"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_ssm_remat_gives_the_same_bits(arch):
    ct = reduced(get_config(arch))
    p = build_model(ct, "cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(ct.vocab, s=40)  # 40 tokens: the SSD pads the second chunk
    a = _port(build_model(ct, "cpu"), p, batch)
    b = _port(build_model(dataclasses.replace(ct, remat="full"), "cpu"), p, batch)
    assert a[0] == b[0]
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
