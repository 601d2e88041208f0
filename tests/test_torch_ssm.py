"""PyTorch port vs JAX package: the Mamba2 stack and the Zamba2 hybrid at a
small size on the CPU, and the init trees and bfloat16 weights of every
family the port added with them (MoE, Mamba2, hybrid).

Inputs are numpy arrays from a seed; the JAX params come from the JAX init
and reach the port through ``params_from_jax``. The reduced configs chunk
the SSD by 32, so a 40-token prompt is padded to two chunks and a 64-token
prompt fills two. Logits and every state leaf (the SSM state, the conv
tails and the shared block's KV caches) must agree within 1e-5 of their max
without CiM (float32 summation order) and 1e-3 with ``fake_quant`` (a
one-ulp difference before ``quantize_symmetric`` can move one activation by
one LSB). The shared block prefills with blocked attention on both sides.
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
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.models import build_model
from repro_torch.models.weights import FLOAT32_LEAVES, params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FQ = dict(mode="fake_quant", ste=False)
B = 2


def _cfgs(arch, cim=None, **over):
    """(JAX cfg, port cfg): the reduced config, float32 unless overridden."""
    cj = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    ct = dataclasses.replace(reduced(get_config(arch)), **over)
    if cim is not None:
        cj = dataclasses.replace(cj, cim=JCiM(**cim))
        ct = dataclasses.replace(ct, cim=CiMConfig(**cim))
    return cj, ct


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{pre}{k}/").items()}
    return {pre: tree}


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _close(a, b, rel, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(), err_msg=what)


@pytest.fixture(scope="module", params=["mamba2-130m", "zamba2-7b"])
def arch_params(request):
    cj, _ = _cfgs(request.param)
    params = jax.jit(j_build_model(cj).init)(jax.random.PRNGKey(0))  # jit: half the eager init's time
    return request.param, jax.tree_util.tree_map(np.array, params)  # writable copies


@pytest.mark.parametrize(
    "s,cim", [(40, None), (40, FQ), (64, None)], ids=["S40-exact", "S40-fake_quant", "S64-exact"]
)
def test_ssm_model_prefill_decode_vs_jax(arch_params, s, cim):
    """Prefill logits and state, then three decode steps' logits and state."""
    arch, np_params = arch_params
    cj, ct = _cfgs(arch, cim)
    mj, mt = j_build_model(cj), build_model(ct, "cpu")
    pt = params_from_jax(np_params, ct, "cpu")
    tokens = np.random.default_rng(5).integers(0, ct.vocab, (B, s)).astype(np.int32)
    rel = 1e-5 if cim is None else 1e-3

    def check(lt, lj, cache_t, cache_j, step):
        _close(lt, lj, rel, f"logits, {step}")
        ft, fj = _flat(cache_t), _flat(jax.tree_util.tree_map(np.asarray, cache_j))
        assert ft.keys() == fj.keys()
        for k in fj:
            assert ft[k].dtype == getattr(torch, fj[k].dtype.name), k
            if fj[k].dtype.kind in "iu":
                np.testing.assert_array_equal(ft[k].numpy(), fj[k], err_msg=f"{k}, {step}")
            else:
                _close(_np(ft[k]), fj[k], rel, f"{k}, {step}")

    lj, cache_j = jax.jit(mj.prefill)(np_params, jnp.asarray(tokens), mj.make_cache(B, s + 3))
    lt, cache_t = mt.prefill(pt, torch.from_numpy(tokens), mt.make_cache(B, s + 3))
    check(lt, lj, cache_t, cache_j, "prefill")
    decode = jax.jit(mj.decode_step)
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for i in range(3):
        lj, cache_j = decode(np_params, jnp.asarray(tok), jnp.asarray(s + i, jnp.int32), cache_j)
        lt, cache_t = mt.decode_step(pt, torch.from_numpy(tok), s + i, cache_t)
        check(lt, lj, cache_t, cache_j, f"decode {i}")
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)


NEW_FAMILIES = ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "mamba2-130m", "zamba2-7b"]


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_init_tree_matches_jax(arch):
    """The port's init has the JAX init's names, shapes and dtypes at
    ``param_dtype="bfloat16"``: the float32 leaves (``FLOAT32_LEAVES``: the
    router, A_log, D, dt_bias and every fan-scaled weight) and the bf16 ones
    (the embedding table, norms and biases)."""
    cj, ct = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    fj = _flat(jax.eval_shape(j_build_model(cj).init, jax.random.PRNGKey(0)))
    ft = _flat(build_model(ct, "cpu").init(torch.Generator().manual_seed(0)))
    assert ft.keys() == fj.keys()
    for k in fj:
        assert tuple(ft[k].shape) == fj[k].shape, k
        assert ft[k].dtype == getattr(torch, fj[k].dtype.name), k
    assert {k.split("/")[-2] for k in fj if fj[k].dtype == jnp.float32} == (
        {k.split("/")[-2] for k in fj} & FLOAT32_LEAVES
    )


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-130m"])
def test_params_from_jax_bfloat16_keeps_float32_leaves(arch):
    """bf16 trees carry across with every leaf's JAX dtype and bits: the
    leaves of ``FLOAT32_LEAVES`` (the router, A_log, D, dt_bias and the
    fan-scaled weights) stay float32, the embedding table, norms and biases
    stay bf16."""
    cj, ct = _cfgs(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    np_params = jax.tree_util.tree_map(np.asarray, j_build_model(cj).init(jax.random.PRNGKey(1)))
    fn, ft = _flat(np_params), _flat(params_from_jax(np_params, ct, "cpu"))
    assert fn.keys() == ft.keys()
    for k, a in fn.items():
        name = k.split("/")[-2]
        want = torch.float32 if name in FLOAT32_LEAVES else torch.bfloat16
        assert ft[k].dtype == want and a.dtype.name == str(want).split(".")[-1], k
        bits = ft[k].view(torch.int16 if want == torch.bfloat16 else torch.int32).numpy()
        np.testing.assert_array_equal(bits, a.view(bits.dtype), err_msg=k)
    with pytest.raises(ValueError, match="the JAX init gives it"):
        params_from_jax(np_params, dataclasses.replace(ct, param_dtype="float32"), "cpu")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_build_model_serves_every_arch(arch):
    """``build_model`` builds every registered arch on the CPU (the full
    config), and the reduced one prefills and decodes to finite logits."""
    assert build_model(get_config(arch), "cpu").config.name == arch
    ct = reduced(get_config(arch))
    m = build_model(ct, "cpu")
    p = m.init(torch.Generator().manual_seed(0))
    if ct.input_kind == "embeddings":
        x, tok = torch.randn(B, 8, ct.d_model), torch.randn(B, ct.d_model)
    else:
        x, tok = torch.randint(0, ct.vocab, (B, 8)), torch.zeros(B, dtype=torch.int32)
    logits, cache = m.prefill(p, x, m.make_cache(B, 9))
    logits, _ = m.decode_step(p, tok, 8, cache)
    assert logits.shape == (B, 1, ct.padded_vocab)
    assert bool(torch.isfinite(logits[..., : ct.vocab]).all())
