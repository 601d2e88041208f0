"""PyTorch port vs JAX package: the training forward and loss of every
family, the CiM straight-through estimator, the RMS norm's and the chunked
loss's gradients, and the forward-only flash path, on the CPU at small sizes.

Inputs are numpy arrays from a seed; the JAX params come from the JAX init
and reach the port through ``params_from_jax``. ``Model.loss_fn`` and its
gradients are held to ``jax.value_and_grad(model.loss_fn)`` (no mesh, so
the JAX package's sharding constraints are no-ops): the loss within 1e-5 of
itself, every gradient leaf within 1e-5 of its largest magnitude without
CiM (float32 summation order through a few layers and the chunked loss;
about 2e-6 is seen) and 1e-4 with ``fake_quant`` + STE (the JAX side runs
eagerly, so the quantization codes agree; the STE's float products differ in
summation order, and a one-ulp difference before ``quantize_symmetric`` can
move one activation by one LSB).
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
from repro.core.cim_linear import cim_matmul as j_cim_matmul
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.core.cim_linear import CiMConfig, cim_matmul
from repro_torch.kernels import cim_matmul as cmm
from repro_torch.launch.train import value_and_grad
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.weights import params_from_jax
from repro_torch.tree import leaves_with_path, path_key

torch.backends.cuda.matmul.allow_tf32 = False

FQ_STE = dict(mode="fake_quant")  # ste=True, the QAT default


@pytest.fixture(autouse=True)
def _no_act_rules():
    JL.set_act_rules(None)
    yield
    JL.set_act_rules(None)


def _cfgs(arch, cim=None, **over):
    cj = dataclasses.replace(j_reduced(j_get_config(arch)), **over)
    ct = dataclasses.replace(reduced(get_config(arch)), **over)
    if cim is not None:
        cj = dataclasses.replace(cj, cim=JCiM(**cim))
        ct = dataclasses.replace(ct, cim=CiMConfig(**cim))
    return cj, ct


def _batch(vocab, b=2, s=64, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1  # ignored positions
    return {"inputs": toks[:, :-1], "labels": labels}


def _port_loss_and_grads(mt, pt, batch):
    """The trainer's own gradient entry point, grads keyed by flat path."""
    (loss, mets), grads = value_and_grad(mt.loss_fn, pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), mets, {path_key(p): g for p, g in leaves_with_path(grads)}


CASES = [
    ("smollm-135m", FQ_STE, {}, 1e-4),
    ("qwen3-moe-30b-a3b", None, {"moe_impl": "scatter"}, 1e-5),
    ("qwen3-moe-30b-a3b", None, {"moe_impl": "dense"}, 1e-5),
]


@pytest.mark.parametrize("arch,cim,over,tol", CASES, ids=["dense-fake_quant-ste", "moe-scatter", "moe-dense"])
def test_loss_and_grads_match_jax(arch, cim, over, tol):
    cj, ct = _cfgs(arch, cim, **over)
    mj, mt = j_build_model(cj), build_model(ct, "cpu")
    pj = jax.jit(mj.init)(jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree_util.tree_map(np.array, pj), ct, "cpu")
    batch = _batch(ct.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.value_and_grad(mj.loss_fn, has_aux=True)
    if cim is None:  # no quantization, so XLA's rewrites cannot move a code
        grad_fn = jax.jit(grad_fn)
    (lj, mets_j), gj = grad_fn(pj, jb)
    lt, mets_t, gt = _port_loss_and_grads(mt, pt, batch)
    assert lt == pytest.approx(float(lj), rel=1e-5)
    for name in ("xent", "aux"):
        assert float(mets_t[name]) == pytest.approx(float(mets_j[name]), rel=1e-5, abs=1e-7)
    if ct.n_experts:
        assert float(mets_t["aux"]) > 0
    flat_j = {path_key(tuple(str(getattr(k, "key", k)) for k in p)): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(gj)[0]}
    assert set(flat_j) == set(gt)
    for key, g in gt.items():
        want = flat_j[key]
        assert g.shape == want.shape, key
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol * scale, f"{arch} grad {key}: {err:.3g} of max {scale:.3g}"


def test_remat_recomputes_the_same_loss_and_grads():
    """``remat="full"`` (a checkpoint per layer and per loss chunk) gives the
    bits of ``remat="none"``."""
    _, ct = _cfgs("smollm-135m", FQ_STE)
    mt = build_model(ct, "cpu")
    p0 = mt.init(torch.Generator().manual_seed(0))
    batch = _batch(ct.vocab)
    a = _port_loss_and_grads(mt, p0, batch)
    mr = build_model(dataclasses.replace(ct, remat="full"), "cpu")
    b = _port_loss_and_grads(mr, p0, batch)
    assert a[0] == b[0]
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_k1_calls_per_training_step(monkeypatch):
    """One training step of the dense model with fake_quant + STE reaches the
    fake-quant kernel's wrapper 7 times a layer in the forward pass and, with
    remat, 7 times a layer again when the backward pass recomputes each
    layer; the STE's backward is a float product. (On the card each call is
    one K1 launch: ``chip_smoke.py`` ``[train]`` holds smollm-135m to
    7 x 30 x 2 = 420.)"""
    calls = []
    real = cmm.cim_matmul_fq
    monkeypatch.setattr(cmm, "cim_matmul_fq", lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in (("none", 7), ("full", 14)):
        _, ct = _cfgs("smollm-135m", FQ_STE, remat=remat)
        mt = build_model(ct, "cpu")
        calls.clear()
        _port_loss_and_grads(mt, mt.init(torch.Generator().manual_seed(0)), _batch(ct.vocab))
        assert len(calls) == want * ct.n_layers, remat


def test_ste_bf16_activations_promote_as_jax():
    """bf16 activations against float32 weights with the STE (the QAT
    default): JAX promotes the float product to float32; the port used to
    raise on ``x @ w``. Value within 1e-6 of max|y| (float32 product
    summation order), float32 out; the gradient is the float product's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) / 8).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    yj, vjp = jax.vjp(lambda a, b: j_cim_matmul(a, b, JCiM(mode="fake_quant")), xb, jnp.asarray(w))
    gxj, gwj = vjp(jnp.ones_like(yj))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    yt = cim_matmul(xt, wt, CiMConfig(mode="fake_quant"))
    assert yt.dtype == torch.float32 and yj.dtype == jnp.float32
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=0, atol=1e-6 * float(np.abs(yj).max()))
    gxt, gwt = torch.autograd.grad(yt.sum(), (xt, wt))
    assert gxt.dtype == torch.bfloat16 and gxj.dtype == jnp.bfloat16
    np.testing.assert_allclose(gxt.float().numpy(), np.asarray(gxj, np.float32), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(gwt.numpy(), np.asarray(gwj), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax_vjp(dtype):
    """``rms_norm`` and its gradients against ``jax.vjp`` of the JAX
    package's: the output and the input's cotangent within 1e-6 (float32) or
    one bf16 ulp (2^-7 relative) of their max. The scale's cotangent is a
    sum over the 15 rows, which XLA's CPU reduction accumulates in bf16 and
    torch's in float32: in bf16 each of its entries is held to the standard
    summation bound (n + 1) 2^-8 sum_i |dy_i xhat_i|."""
    rng = np.random.default_rng(1)
    x, scale, dy = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 64), (64,), (3, 5, 64)))
    jdt = jnp.dtype(dtype)
    yj, vjp = jax.vjp(lambda a, s: JL.rms_norm(a, s, 1e-5), jnp.asarray(x, jdt), jnp.asarray(scale, jdt))
    dxj, dsj = vjp(jnp.asarray(dy, jdt))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scale).to(tdt).requires_grad_(True)
    yt = L.rms_norm(xt, st, 1e-5)
    dxt, dst = torch.autograd.grad(yt, (xt, st), torch.from_numpy(dy).to(tdt))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for t, j in ((yt, yj), (dxt, dxj), (dst, dsj)):
        assert t.dtype == tdt
        j = np.asarray(j, np.float32)
        if t is dst and dtype == "bfloat16":
            xb = xt.detach().double().numpy()
            xhat = xb / np.sqrt(np.mean(xb * xb, axis=-1, keepdims=True) + 1e-5)
            dyb = torch.from_numpy(dy).to(tdt).double().numpy()
            terms = np.abs(dyb * xhat).reshape(-1, x.shape[-1])
            bound = (terms.shape[0] + 1) * 2.0 ** -8 * terms.sum(axis=0)
            assert np.all(np.abs(t.float().numpy() - j) <= bound)
            continue
        np.testing.assert_allclose(t.detach().float().numpy(), j, rtol=0, atol=tol * float(np.abs(j).max()))


def test_chunked_xent_matches_jax():
    """``chunked_xent`` over two loss chunks, with ignored labels and a
    padded vocab (250 of 256 rows live), against the JAX package's: the loss
    within 1e-6 relative, the gradients of the hidden states and the
    unembedding within 1e-5 of their max."""
    cj, ct = _cfgs("smollm-135m", vocab=250, tie_embeddings=False)
    assert ct.padded_vocab == cj.padded_vocab == 256
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 2 * ct.loss_chunk, ct.d_model)).astype(np.float32)
    w = (rng.standard_normal((ct.d_model, ct.padded_vocab)) / 8).astype(np.float32)
    labels = _batch(ct.vocab, s=2 * ct.loss_chunk)["labels"]
    lj, (dhj, dwj) = jax.value_and_grad(
        lambda hh, ww: JL.chunked_xent({"unembed": ww}, hh, jnp.asarray(labels), cj), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(w))
    ht, wt = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    lt = L.chunked_xent({"unembed": wt}, ht, torch.from_numpy(labels), ct)
    dht, dwt = torch.autograd.grad(lt, (ht, wt))
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-6)
    assert float(np.abs(np.asarray(dwj)[:, ct.vocab:]).max()) == float(dwt[:, ct.vocab:].abs().max()) == 0.0
    for t, j in ((dht, dhj), (dwt, dwj)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * float(np.abs(j).max()))


def test_flash_path_raises_under_autograd():
    """The flash path is forward-only, as in the JAX package: under autograd
    it raises (naming the blocked path) instead of cutting the attention
    gradients; without grad it runs."""
    _, ct = _cfgs("smollm-135m", attn_impl="flash")
    mt = build_model(ct, "cpu")
    p = mt.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(ct.vocab, s=128)["inputs"])
    p["attn"]["wq"].requires_grad_(True)
    with pytest.raises(RuntimeError, match='forward-only.*attn_impl="blocked"'):
        mt.loss_fn(p, {"inputs": toks, "labels": toks})
    with torch.no_grad():
        loss, _ = mt.loss_fn(p, {"inputs": toks, "labels": toks})
    assert torch.isfinite(loss)
