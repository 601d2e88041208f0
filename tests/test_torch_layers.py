"""PyTorch port vs JAX package: layers and the whole dense model at a small
size, on the CPU.

The JAX params come from the JAX ``init_transformer`` and reach the port
through ``params_from_jax``. The port's ``attn_impl="flash"`` prefill is held
against the JAX ``attn_impl="blocked"`` path, since the JAX flash kernel does
not run on this jax version. Tolerances: without CiM, 1e-5 of max|logit|
(float32 summation order); with ``fake_quant``, 1e-3, because a one-ulp
difference before ``quantize_symmetric`` can move one activation by one LSB.
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
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.weights import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, S = 2, 128


def _cfgs(cim=None, arch="smollm-135m", **over):
    """(JAX cfg, port cfg): the reduced ``arch`` (smollm-135m) in float32."""
    cj = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    ct = dataclasses.replace(reduced(get_config(arch)), **over)
    if cim is not None:
        cj = dataclasses.replace(cj, cim=JCiM(**cim))
        ct = dataclasses.replace(ct, cim=CiMConfig(**cim))
    return cj, ct


@pytest.fixture(scope="module")
def np_params():
    cj, _ = _cfgs()
    params = j_build_model(cj).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.array, params)  # writable copies


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def test_config_registry_matches_jax():
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS

    assert sorted(ARCHS) == sorted(JARCHS)
    for name, cfg in ARCHS.items():
        j = dataclasses.asdict(JARCHS[name])
        t = dataclasses.asdict(cfg)
        assert t == j, name
        assert cfg.padded_vocab == JARCHS[name].padded_vocab
        assert cfg.n_params() == JARCHS[name].n_params()
        assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(j_reduced(JARCHS[name]))


def test_params_from_jax_keeps_names_shapes_dtypes(np_params):
    _, ct = _cfgs()
    p = params_from_jax(np_params, ct, "cpu")
    init = build_model(ct, "cpu").init(torch.Generator().manual_seed(0))
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{pre}{k}/").items()}
        if isinstance(t, dict) else {pre: t}
    )
    fp, fi, fn = flat(p), flat(init), flat(np_params)
    assert fp.keys() == fi.keys() == fn.keys()
    for k in fp:
        assert tuple(fp[k].shape) == tuple(fi[k].shape) == fn[k].shape, k
        assert fp[k].dtype == fi[k].dtype == torch.float32, k
        np.testing.assert_array_equal(fp[k].numpy(), fn[k])


def test_params_from_jax_bfloat16_bit_exact():
    _, ct = _cfgs(param_dtype="bfloat16")
    a = jnp.asarray(_normal((5, 7), 1), jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(a)}, ct, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("cim", [None, dict(mode="fake_quant", ste=False)])
def test_dense_and_mlp(np_params, cim):
    cj, ct = _cfgs(cim)
    x = _normal((B, 8, ct.d_model), 2)
    w = np.array(np_params["attn"]["wq"][0])
    j_dense = jax.jit(JL.dense, static_argnums=(2, 3))
    _close(TL.dense(torch.from_numpy(x), torch.from_numpy(w), cim=ct.cim),
           j_dense(jnp.asarray(x), jnp.asarray(w), None, cj.cim), 1e-5)
    pm = {k: v[0] for k, v in np_params["mlp"].items()}
    y_t = TL.mlp({k: torch.from_numpy(v) for k, v in pm.items()}, torch.from_numpy(x), ct)
    y_j = jax.jit(JL.mlp, static_argnums=2)({k: jnp.asarray(v) for k, v in pm.items()}, jnp.asarray(x), cj)
    _close(y_t, y_j, 1e-5 if cim is None else 1e-3)


def test_rms_norm_and_rope():
    x = _normal((B, 16, 4, 16), 3)
    scale = _normal((16,), 4) * 0.1
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           jax.jit(JL.rms_norm, static_argnums=2)(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    pos = np.arange(3, 19, dtype=np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jax.jit(JL.apply_rope, static_argnums=2)(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-6)


@pytest.mark.parametrize("attn_impl,window", [("blocked", None), ("blocked", 48), ("flash", None)])
def test_prefill_attention_vs_jax_blocked(np_params, attn_impl, window):
    cj, _ = _cfgs(sliding_window=window)
    _, ct = _cfgs(sliding_window=window, attn_impl=attn_impl)
    pa = {k: v[0] for k, v in np_params["attn"].items()}
    x = _normal((B, S, ct.d_model), 5)
    pos = np.arange(S, dtype=np.int32)
    sc = S if window is None else window
    cache_t = {k: v[0] for k, v in TL.make_attn_cache(ct, B, sc, 1, "cpu").items()}
    cache_j = {k: v[0] for k, v in JL.make_attn_cache(cj, B, sc, 1).items()}
    y_t, cache_t = TL.attention({k: torch.from_numpy(v) for k, v in pa.items()},
                                torch.from_numpy(x), ct, torch.from_numpy(pos), cache_t)
    y_j, cache_j = jax.jit(JL.attention, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in pa.items()}, jnp.asarray(x), cj, jnp.asarray(pos), cache_j)
    _close(y_t, y_j, 1e-5)
    _close(cache_t["k"], cache_j["k"], 1e-5)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))


@pytest.mark.parametrize("int8_kv", [False, True])
def test_decode_attention_vs_jax(np_params, int8_kv):
    cj, ct = _cfgs(kv_quant_int8=int8_kv)
    pa = {k: v[0] for k, v in np_params["attn"].items()}
    x = _normal((B, 40, ct.d_model), 6)
    pos = np.arange(40, dtype=np.int32)
    pt = {k: torch.from_numpy(v) for k, v in pa.items()}
    pj = {k: jnp.asarray(v) for k, v in pa.items()}
    cache_t = {k: v[0] for k, v in TL.make_attn_cache(ct, B, 48, 1, "cpu").items()}
    cache_j = {k: v[0] for k, v in JL.make_attn_cache(cj, B, 48, 1).items()}
    _, cache_t = TL.attention(pt, torch.from_numpy(x[:, :39]), ct, torch.from_numpy(pos[:39]), cache_t)
    _, cache_j = jax.jit(JL.attention, static_argnums=2)(pj, jnp.asarray(x[:, :39]), cj, jnp.asarray(pos[:39]), cache_j)
    if int8_kv:
        assert cache_t["k"].dtype == torch.int8
        np.testing.assert_allclose(cache_t["k_scale"].numpy(), np.asarray(cache_j["k_scale"]), rtol=1e-6)
    y_t, cache_t = TL.decode_attention(pt, torch.from_numpy(x[:, 39:]), ct, 39, cache_t)
    y_j, cache_j = jax.jit(JL.decode_attention, static_argnums=2)(
        pj, jnp.asarray(x[:, 39:]), cj, jnp.asarray(39, jnp.int32), cache_j)
    _close(y_t, y_j, 1e-5 if not int8_kv else 1e-3)
    np.testing.assert_array_equal(cache_t["pos"].numpy(), np.asarray(cache_j["pos"]))


@pytest.mark.parametrize(
    "arch,cim,kv_int8,rel",
    [
        ("smollm-135m", None, False, 1e-5),
        ("smollm-135m", dict(mode="fake_quant", ste=False), False, 1e-3),
        ("smollm-135m", None, True, 1e-3),
        ("qwen2.5-32b", None, False, 1e-5),
        ("qwen2.5-32b", dict(mode="fake_quant", ste=False), False, 1e-3),
        ("pixtral-12b", None, False, 1e-5),
    ],
    ids=["exact", "fake_quant", "int8_kv", "qwen2.5-qkv_bias-exact", "qwen2.5-qkv_bias-fake_quant",
         "pixtral-embeddings-exact"],
)
def test_model_prefill_decode_vs_jax(np_params, arch, cim, kv_int8, rel):
    """Whole reduced model: port (flash prefill) vs JAX (blocked prefill),
    prefill logits and three decode steps. qwen2.5 carries q/k/v biases
    (drawn at random here: the init's are zero), pixtral takes embeddings
    in place of tokens, at prefill and at every decode step."""
    cj, _ = _cfgs(cim, arch, kv_quant_int8=kv_int8)
    _, ct = _cfgs(cim, arch, kv_quant_int8=kv_int8, attn_impl="flash")
    mj, mt = j_build_model(cj), build_model(ct, "cpu")
    rng = np.random.default_rng(7)
    if arch != "smollm-135m":
        np_params = jax.tree_util.tree_map(np.array, mj.init(jax.random.PRNGKey(0)))
        for name in ("bq", "bk", "bv"):
            if name in np_params["attn"]:
                np_params["attn"][name] = 0.1 * _normal(np_params["attn"][name].shape, 8 + len(name))
    pt = params_from_jax(np_params, ct, "cpu")
    embeddings = ct.input_kind == "embeddings"
    if embeddings:
        inputs = _normal((B, S, ct.d_model), 9)
    else:
        inputs = rng.integers(0, ct.vocab, (B, S)).astype(np.int32)
    total = S + 3
    lj, cache_j = jax.jit(mj.prefill)(np_params, jnp.asarray(inputs), mj.make_cache(B, total))
    lt, cache_t = mt.prefill(pt, torch.from_numpy(inputs), mt.make_cache(B, total))
    _close(lt, lj, rel)
    decode = jax.jit(mj.decode_step)
    tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
    for i in range(3):
        if embeddings:
            tok = _normal((B, ct.d_model), 10 + i)
        lj, cache_j = decode(np_params, jnp.asarray(tok), jnp.asarray(S + i, jnp.int32), cache_j)
        lt, cache_t = mt.decode_step(pt, torch.from_numpy(tok), S + i, cache_t)
        _close(lt, lj, rel)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
