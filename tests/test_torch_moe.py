"""PyTorch port vs JAX package: the MoE feed-forward and the whole reduced
MoE models, on the CPU.

Inputs are numpy arrays from a seed; the JAX params come from the JAX init
and reach the port through ``params_from_jax``. Tolerances: routing indices
and the capacity ``keep`` mask are equal; gates within 1e-6 relative (an ulp
or two: XLA's ``exp`` and PyTorch's part in the last bit on ~10% of inputs);
``y`` and logits within 1e-5 of max|y| without CiM (float32 summation order)
and 1e-3 with ``fake_quant`` (a one-ulp difference before
``quantize_symmetric`` can move one activation by one LSB); ``aux`` within
1e-6. Both sides prefill with blocked attention (S <= 64 is below the flash
prefill's 128-query block).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.cim_linear import CiMConfig as JCiM
from repro.models import build_model as j_build_model
from repro.models import moe as JM
from repro_torch.configs import get_config, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.models.weights import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCHS = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"]
FQ = dict(mode="fake_quant", ste=False)
B, S = 2, 40


def _cfgs(arch, cim=None, **over):
    """(JAX cfg, port cfg): the reduced config in float32."""
    cj = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    ct = dataclasses.replace(reduced(get_config(arch)), **over)
    if cim is not None:
        cj = dataclasses.replace(cj, cim=JCiM(**cim))
        ct = dataclasses.replace(ct, cim=CiMConfig(**cim))
    return cj, ct


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    cj, _ = _cfgs(request.param)
    params = j_build_model(cj).init(jax.random.PRNGKey(0))
    return request.param, jax.tree_util.tree_map(np.array, params)  # writable copies


def _layer0(np_params):
    return {k: v[0] for k, v in np_params["moe"].items()}


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def _j_route(p, x, cfg):
    """The JAX package's routing (``moe.py``, the lines before dispatch)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ jnp.asarray(p["router"])).astype(jnp.float32), axis=-1)
    gate, idx = jax.lax.top_k(probs, cfg.top_k)
    return gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), idx


def _j_keep(idx, cfg, cap):
    """The JAX package's capacity mask (``moe.py``: choice-major cumsum)."""
    idx_f = idx.T.reshape(-1)
    pos_f = jnp.cumsum(jax.nn.one_hot(idx_f, cfg.n_experts, dtype=jnp.float32), axis=0) - 1.0
    return jnp.take_along_axis(pos_f, idx_f[:, None], axis=1)[:, 0] < cap


def _check_ffn(p, x, cj, ct):
    """Routing, capacity mask, ``y`` and ``aux`` of both MoE functions."""
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    _, gate_t, idx_t = TM.route(pt["router"], xt.reshape(-1, x.shape[-1]), ct.top_k)
    gate_j, idx_j = _j_route(p, x, cj)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j), rtol=1e-6, atol=0)
    cap = TM.expert_capacity(x.shape[0] * x.shape[1], ct)
    assert cap == JM.expert_capacity(x.shape[0] * x.shape[1], cj)
    keep_t = TM._dispatch(idx_t, ct.n_experts, cap)[2]
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(_j_keep(idx_j, cj, cap)))
    rel = 1e-5 if ct.cim is None else 1e-3
    for t_fn, j_fn in ((TM.moe_ffn, JM.moe_ffn), (TM.moe_ffn_dense, JM.moe_ffn_dense)):
        y_t, aux_t = t_fn(pt, xt, ct)
        y_j, aux_j = jax.jit(j_fn, static_argnums=2)(pj, jnp.asarray(x), cj)
        _close(y_t, y_j, rel)
        np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=0, atol=1e-6)
    return keep_t


@pytest.mark.parametrize("cim", [None, FQ], ids=["exact", "fake_quant"])
def test_moe_ffn_vs_jax(arch_params, cim):
    arch, np_params = arch_params
    cj, ct = _cfgs(arch, cim)
    x = np.random.default_rng(1).standard_normal((B, S, ct.d_model)).astype(np.float32)
    _check_ffn(_layer0(np_params), x, cj, ct)


def test_moe_ffn_capacity_drops_vs_jax(arch_params):
    """capacity_factor 0.25: most experts overflow, and the dropped choices
    (gate zeroed) must be the JAX package's."""
    arch, np_params = arch_params
    cj, ct = _cfgs(arch, capacity_factor=0.25)
    x = np.random.default_rng(2).standard_normal((B, S, ct.d_model)).astype(np.float32)
    keep = _check_ffn(_layer0(np_params), x, cj, ct)
    assert 0 < int((~keep).sum()) < keep.numel()


def test_moe_ffn_router_ties_vs_jax(arch_params):
    """Exact ties: integer activations through a router of multiples of 1/8
    with duplicated columns give equal logits in any summation order. The
    top k takes the lower expert index first, as ``jax.lax.top_k`` does
    (``torch.topk`` orders some tied rows otherwise), and at capacity 0.25
    that order decides which choices are dropped."""
    arch, np_params = arch_params
    cj, ct = _cfgs(arch, capacity_factor=0.25)
    rng = np.random.default_rng(3)
    p = _layer0(np_params)
    router = rng.integers(-1, 2, p["router"].shape).astype(np.float32) / 8
    router[:, 5], router[:, 6], router[:, 7] = router[:, 1], router[:, 2], router[:, 1]
    p["router"] = router
    x = rng.integers(-2, 3, (B, S, ct.d_model)).astype(np.float32)
    probs, _, idx = TM.route(torch.from_numpy(router), torch.from_numpy(x.reshape(-1, ct.d_model)), ct.top_k)
    top = torch.gather(probs, 1, idx)
    assert int((probs[:, None, :] == top[:, :, None]).sum(-1).gt(1).any(-1).sum()) > 10  # tied rows
    assert not torch.equal(torch.topk(probs, ct.top_k).indices, idx)
    keep = _check_ffn(p, x, cj, ct)
    assert 0 < int((~keep).sum()) < keep.numel()


@pytest.mark.parametrize("moe_impl", ["dense", "scatter"])
@pytest.mark.parametrize("cim", [None, FQ], ids=["exact", "fake_quant"])
def test_moe_model_prefill_decode_vs_jax(arch_params, moe_impl, cim):
    """The whole reduced MoE model: prefill logits and three decode steps."""
    arch, np_params = arch_params
    cj, ct = _cfgs(arch, cim, moe_impl=moe_impl)
    mj, mt = j_build_model(cj), build_model(ct, "cpu")
    pt = params_from_jax(np_params, ct, "cpu")
    tokens = np.random.default_rng(4).integers(0, ct.vocab, (B, S)).astype(np.int32)
    rel = 1e-5 if cim is None else 1e-3
    lj, cache_j = jax.jit(mj.prefill)(np_params, jnp.asarray(tokens), mj.make_cache(B, S + 3))
    lt, cache_t = mt.prefill(pt, torch.from_numpy(tokens), mt.make_cache(B, S + 3))
    _close(lt, lj, rel)
    decode = jax.jit(mj.decode_step)
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for i in range(3):
        lj, cache_j = decode(np_params, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32), cache_j)
        lt, cache_t = mt.decode_step(pt, torch.from_numpy(tok), S + i, cache_t)
        _close(lt, lj, rel)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    _close(cache_t["k"], cache_j["k"], rel)
    _close(cache_t["v"], cache_j["v"], rel)
