"""The port's training loops on the CPU: the LM trainer (loss descent,
microbatch accumulation, checkpoint and resume, supervised restart, the
watchdog, the CLI) and the MNIST trainer (one epoch against the JAX
package's, the QAT kernel calls).

Microbatch accumulation adds the microbatches' float32 gradients in order
where the full batch sums all tokens at once, so the losses agree within
1e-5 of themselves over 4 steps. A run interrupted and resumed from its
checkpoint gives the uninterrupted run's losses bit for bit (float32 and
bf16 params: bf16 leaves are checkpointed as their bit patterns).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.train import mnist_mlp as J
from repro_torch.configs import get_config, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.ft import Watchdog, run_with_restart
from repro_torch.kernels import cim_matmul as cmm
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import TrainSettings, train
from repro_torch.train import mnist_mlp as T


def _cfg(**over):
    return reduced(get_config("smollm-135m"), n_layers=2, d_model=32, vocab=64, n_heads=2, n_kv_heads=1,
                   d_ff=64, head_dim=16, **over)


def test_loss_decreases(tmp_path):
    st = TrainSettings(steps=30, batch=8, seq=64, lr=2e-3, warmup=5, ckpt_dir=str(tmp_path), ckpt_every=100,
                       log_every=100)
    out = train(_cfg(), st, device="cpu")
    assert out["final_loss"] < out["first_loss"] - 0.1
    assert len(out["step_s"]) == 30


def test_microbatch_accumulation_matches_full_batch(tmp_path):
    base = dict(steps=4, batch=8, seq=32, lr=1e-3, warmup=1, log_every=100, ckpt_every=1000)
    full = train(_cfg(), TrainSettings(ckpt_dir=str(tmp_path / "f"), microbatches=1, **base), device="cpu")
    acc = train(_cfg(), TrainSettings(ckpt_dir=str(tmp_path / "m"), microbatches=2, **base), device="cpu")
    np.testing.assert_allclose(acc["losses"], full["losses"], rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_continues_identically(tmp_path, dtype):
    cfg = _cfg(param_dtype=dtype, compute_dtype=dtype)
    base = dict(steps=8, batch=4, seq=32, lr=1e-3, warmup=2, log_every=100)
    out_a = train(cfg, TrainSettings(ckpt_dir=str(tmp_path / "a"), ckpt_every=1000, **base), device="cpu")
    st_b = TrainSettings(ckpt_dir=str(tmp_path / "b"), ckpt_every=4, **base)
    first = train(cfg, st_b, device="cpu", stop_at=4)
    second = train(cfg, st_b, device="cpu")
    assert first["losses"] + second["losses"] == out_a["losses"]
    for k, v in out_a["params"].items():
        if not isinstance(v, dict):
            assert torch.equal(v, second["params"][k]), k


def test_run_with_restart_recovers():
    calls = {"n": 0}

    def flaky(resume):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("simulated node failure")
        return 42

    assert run_with_restart(flaky, max_restarts=3) == 42
    assert calls["n"] == 3
    with pytest.raises(RuntimeError, match="simulated"):
        run_with_restart(lambda r: (_ for _ in ()).throw(RuntimeError("simulated")), max_restarts=1)


def test_watchdog_flags_stragglers(tmp_path):
    wd = Watchdog(tmp_path / "hb.json", straggler_factor=3.0, ema_alpha=0.5)
    wd.step(0)
    for s in range(1, 4):
        time.sleep(0.01)
        wd.step(s)
    time.sleep(0.2)
    assert wd.step(4)["straggler"] and wd.stragglers == 1
    assert (tmp_path / "hb.json").exists()


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert "[train] done" in capsys.readouterr().out
    assert (tmp_path / "step_000000003" / "manifest.json").exists()


def test_mnist_one_epoch_equals_jax():
    """One float epoch (64 SGD steps, shuffled by the same numpy generator):
    the same test accuracy as the JAX package's ``train_mlp``, and weights
    within 1e-5 of their largest magnitude (float32 summation order)."""
    pt, acc_t = T.train_mlp(epochs=1, device="cpu")
    pj, acc_j = J.train_mlp(epochs=1)
    assert acc_t == acc_j
    for mine, ref in zip(pt, pj):
        want = np.asarray(ref["w"])
        np.testing.assert_allclose(mine["w"].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mnist_qat_reaches_the_fake_quant_kernel_three_times_a_step(monkeypatch):
    """``train_mlp(qat_cim=...)``: every linear through the fake-quant
    kernel's wrapper in the forward pass (3 a step), none in the backward
    (the STE's float product). On the card each is one K1 launch."""
    calls = []
    real = cmm.cim_matmul_fq
    monkeypatch.setattr(cmm, "cim_matmul_fq", lambda *a, **k: calls.append(1) or real(*a, **k))
    qat = CiMConfig(mode="fake_quant", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False)
    _, acc = T.train_mlp(epochs=1, qat_cim=qat, device="cpu")
    assert len(calls) == 3 * 64  # 8192 images in batches of 128
    assert 0.1 < acc <= 1.0


def test_trainers_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(_cfg(), TrainSettings(steps=1, ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.train_mlp(epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.evaluate([], None)
