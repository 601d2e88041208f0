"""PyTorch port vs JAX package: LR schedules, AdamW, Adafactor, int8
gradient compression and checkpoints, on the CPU.

The schedules and AdamW agree within 1e-6 relative (``cos`` and ``pow`` are
libm's in torch and XLA's in JAX, a few ulp apart). Adafactor's ``rsqrt``
is XLA's own approximation on the CPU, not correctly rounded, so its
updates and state agree within 1e-6 relative (8 float32 ulp; 1-2 ulp is
seen). ``quantize_int8`` is bit-exact against eager JAX, and
``compressed_psum_tree`` over 4 ranks bit-exact against the JAX
``shard_map`` version on 4 CPU devices (the mean and every rank's
residual). A float32 checkpoint written by either package restores in the
other to the same bits; bf16 leaves restore bit-exact in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.checkpoint import ckpt as jckpt
from repro.optim import adafactor_init as j_af_init
from repro.optim import adafactor_update as j_af_update
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import grad_compression as jgc
from repro.optim import warmup_cosine as j_cos
from repro.optim import warmup_linear as j_lin
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.optim import adafactor_init, adafactor_update, adamw_init, adamw_update, make_optimizer
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import warmup_cosine, warmup_linear
from repro_torch.tree import tree_leaves, tree_map


def _tree(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"b": (7,), "w": (16, 8), "blk": {"k": (2, 4, 6), "s": ()}}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) else np.asarray(rng.standard_normal(s), np.float32)

    return draw(shapes)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), tree)


def _close(t, j, rel):
    for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-30))


def test_schedules_match_jax():
    for step in (0, 1, 5, 9, 10, 11, 40, 99, 100, 150):
        for ours, ref in ((warmup_cosine, j_cos), (warmup_linear, j_lin)):
            got, want = ours(step, 3e-4, 10, 100), ref(jnp.asarray(step), 3e-4, 10, 100)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)
    assert float(warmup_cosine(torch.tensor(100, dtype=torch.int32), 1.0, 10, 100)) == pytest.approx(0.1)


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_jax(clip):
    params, grads = _tree(0), tree_map(lambda g: 3 * g, _tree(1))
    sj, st = j_adamw_init(_j(params)), adamw_init(_t(params))
    pj, pt = _j(params), _t(params)
    for i in range(3):
        g = tree_map(lambda x: (i + 1) * x, grads)
        pj, sj, mj = j_adamw_update(_j(g), sj, pj, jnp.float32(1e-2), grad_clip=clip)
        pt, st, mt = adamw_update(_t(g), st, pt, torch.tensor(1e-2), grad_clip=clip)
    _close(pt, pj, 1e-6)
    _close(st.m, sj.m, 1e-6)
    _close(st.v, sj.v, 1e-6)
    assert int(st.count) == int(sj.count) == 3 and st.count.dtype == torch.int32
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=1e-6)


def test_adamw_bf16_params_keep_float32_state():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}
    newp, st, _ = adamw_update(g, adamw_init(p), p, 1e-2)
    pj, sj, _ = j_adamw_update({"w": jnp.full((4, 4), 0.5, jnp.bfloat16)}, j_adamw_init({"w": jnp.ones((4, 4), jnp.bfloat16)}),
                               {"w": jnp.ones((4, 4), jnp.bfloat16)}, jnp.float32(1e-2))
    assert newp["w"].dtype == torch.bfloat16 and st.m["w"].dtype == torch.float32
    assert np.array_equal(newp["w"].float().numpy(), np.asarray(pj["w"], np.float32))
    np.testing.assert_allclose(st.v["w"].numpy(), np.asarray(sj.v["w"]), rtol=1e-6)


def test_adafactor_matches_jax():
    params, grads = _tree(2), _tree(3)
    sj, st = j_af_init(_j(params)), adafactor_init(_t(params))
    assert st.v_row["w"].shape == (16,) and st.v_col["w"].shape == (8,) and st.v_full["b"].shape == (7,)
    pj, pt = _j(params), _t(params)
    for i in range(3):
        g = tree_map(lambda x: (1 + i) * x, grads)
        pj, sj, _ = j_af_update(_j(g), sj, pj, jnp.float32(1e-2), weight_decay=0.01)
        pt, st, _ = adafactor_update(_t(g), st, pt, torch.tensor(1e-2), weight_decay=0.01)
    _close(pt, pj, 1e-6)
    for a, b in ((st.v_row, sj.v_row), (st.v_col, sj.v_col), (st.v_full, sj.v_full)):
        _close(a, b, 1e-6)
    assert make_optimizer("adafactor") == (adafactor_init, adafactor_update)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


def test_quantize_int8_is_bit_exact():
    rng = np.random.default_rng(4)
    for g in (rng.standard_normal((33, 17)).astype(np.float32), np.zeros(5, np.float32),
              np.array([1.5, -127.0, 0.5, 2.5], np.float32)):
        q, s = gc.quantize_int8(torch.from_numpy(g))
        qj, sj = jgc.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(qj))
        assert np.array_equal(s.numpy(), np.asarray(sj))
        assert np.array_equal(gc.dequantize_int8(q, s).numpy(), np.asarray(jgc.dequantize_int8(qj, sj)))


def test_compressed_psum_tree_matches_shard_map():
    n = 4
    ranks = [_tree(10 + r, {"a": (5, 3), "b": (9,)}) for r in range(n)]
    errs = [_tree(20 + r, {"a": (5, 3), "b": (9,)}) for r in range(n)]
    errs = [tree_map(lambda e: 1e-3 * e, e) for e in errs]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)  # noqa: E731
    fn = jax.shard_map(
        lambda g, e: jgc.compressed_psum_tree(jax.tree.map(lambda x: x[0], g), "dp", jax.tree.map(lambda x: x[0], e)),
        mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P(), P("dp")), check_vma=False,
    )
    mean_j, resid_j = fn(stack(ranks), stack(errs))
    mean_t, resid_t = gc.compressed_psum_tree([_t(r) for r in ranks], [_t(e) for e in errs])
    for key in ("a", "b"):
        assert np.array_equal(mean_t[key].numpy(), np.asarray(mean_j[key]))
        per_rank = np.asarray(resid_j[key]).reshape(n, *ranks[0][key].shape)
        for r in range(n):
            assert np.array_equal(resid_t[r][key].numpy(), per_rank[r])
    assert set(gc.init_error_feedback(_t(ranks[0]))) == {"a", "b"}


def test_checkpoints_restore_across_packages(tmp_path):
    params = _tree(5)
    state = adamw_init(_t(params))
    # the port writes, JAX restores
    save(tmp_path / "t", 7, {"params": _t(params), "opt": state})
    like_j = {"params": _j(params), "opt": j_adamw_init(_j(params))}
    got = jckpt.restore(tmp_path / "t", 7, like_j)
    for a, b in zip(jax.tree.leaves(got), tree_leaves({"params": _t(params), "opt": state})):
        assert np.array_equal(np.asarray(a), b.numpy())
    # JAX writes, the port restores
    jckpt.save(tmp_path / "j", 3, like_j)
    back = restore(tmp_path / "j", 3, {"params": _t(params), "opt": state})
    assert back["opt"].count.dtype == torch.int32
    for a, b in zip(tree_leaves(back), jax.tree.leaves(like_j)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_checkpoint_bf16_leaves_and_gc(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"x": x, "y": [torch.arange(4, dtype=torch.int32)]}
    ck = Checkpointer(tmp_path, keep_last=2)
    for step in (1, 2, 3):
        ck.save_async(step, tree)
    ck.wait()
    assert latest_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000002", "step_000000003"]
    back = restore(tmp_path, 3, tree)
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(back["y"][0], tree["y"][0])
    assert latest_step(tmp_path / "none") is None
