"""The run as a whole on the CPU at the reduced sizes: ``run.py`` refuses
without a card; a sound run is correct; each fault a serving cell can have,
planted under the timed path, makes ``correct`` false, NaN logits too; the
control (the reference one precision down in the program's place) is judged
not correct by the run's own judgement."""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench, check, run
from portbench.tests.tiny import tiny_root

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"), "bfloat16")


@pytest.fixture(scope="module")
def tiny_two(tmp_path_factory):
    """Two prompt lengths in every mix and two calls checked."""
    return tiny_root(tmp_path_factory.mktemp("tiny_two"), "bfloat16", check_calls=2, lens=2)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", WORKLOADS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_compare_whole_names():
    loaded = ["torch", "repro_torch", "repro_torch.launch.serve", "portbench.bench", "jaxtyping"]
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(loaded + ["repro.core.cim_linear", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tiny, workload):
    out = bench.run_cell(tiny, workload, SEED, 0.01, False, "cpu")
    assert out["correct"] and out["failed"] == 0, out["check"]
    assert list(out)[-1] == "check" and out["check"]
    assert out["metrics"]["setup_s"]["value"] > 0


def _faulty(monkeypatch, fault):
    import repro_torch.launch.serve as serve

    real_serve, real_build = serve.serve_batch, serve.build_model

    def stale(cfg, device):
        m = real_build(cfg, device)

        def decode_step(p, token, pos, cache):  # the step returns its state unchanged
            logits, _ = m.decode_step(p, token, pos, copy.deepcopy(cache))
            return logits, cache

        return m._replace(decode_step=decode_step)

    def served(*a, **k):
        out = real_serve(*a, **k)
        g = np.array(out["generated"])
        b = g.shape[0]
        if fault == "token":  # one token altered where it is produced
            g[0, -1] = (g[0, -1] + 1) % 7
        elif fault == "half":  # half of the batch left out: the rest answered with the first half's outputs
            g[b // 2:] = g[: b - b // 2]
            out["logits"] = torch.cat([out["logits"][: b - b // 2]] * 2)[:b]
        elif fault == "nan" and a[1].prompt_len < SHORT_MAX:  # NaN logits from the calls checked second
            # at the served token, so the first choice (argmax takes NaN as the largest) is still it
            out["logits"] = out["logits"].clone()
            out["logits"][torch.arange(b), -1, torch.as_tensor(g[:, -1]).long()] = float("nan")
        out["generated"] = g
        return out

    if fault == "state":
        monkeypatch.setattr(serve, "build_model", stale)
    else:
        monkeypatch.setattr(serve, "serve_batch", served)


FAULTS = [(w, f) for w in WORKLOADS for f in ("token", "half")] + [
    (w, "state") for w in WORKLOADS if "generate" in w]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    _faulty(monkeypatch, fault)
    out = bench.run_cell(tiny, workload, SEED, 0.01, False, "cpu")
    assert not out["correct"], (fault, out["check"])


# the tiny mixes' lengths are 128 and 256: the call with the longest prompt is checked first
SHORT_MAX = 256


@pytest.mark.parametrize("workload", WORKLOADS)
def test_nan_in_a_second_checked_call_is_not_correct(tiny_two, monkeypatch, workload):
    """NaN logits in the second of two checked calls (the first, with the
    longest prompt, sound) fail the check: NaN passes no limit."""
    _faulty(monkeypatch, "nan")
    out = bench.run_cell(tiny_two, workload, SEED, 0.01, False, "cpu")
    assert not out["correct"] and out["failed"] > 0, out["check"]
    assert out["check"]["logit_err"][0] == "nan" and out["check"]["token_mismatch"][0] == 0
    json.loads(json.dumps(out["metrics"] | {"check": out["check"]}), parse_constant=pytest.fail)


@pytest.mark.parametrize("row", ["row_gap", "row_err"])
def test_judge_fails_nan_after_a_sound_call(row):
    lim = {"gap": 1.0, "logit_err": 0.05, "token_mismatch": 0.0}

    def call(**rows):
        base = {"row_gap": torch.zeros(3), "row_err": torch.full((3,), 1e-4), "row_mismatch": torch.zeros(3)}
        base.update(rows)
        return {"gap": float(base["row_gap"].max()), "logit_err": float(base["row_err"].max()),
                "token_mismatch": float(base["row_mismatch"].sum()), **base}

    sound = call()
    assert check.judge([sound, call()], lim)[:2] == (True, 0)
    bad = call(**{row: torch.tensor([1e-4, float("nan"), 1e-4])})
    correct, failed, shown = check.judge([sound, bad], lim)
    assert not correct and failed == 1
    assert shown[{"row_gap": "gap", "row_err": "logit_err"}[row]][0] == "nan"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(tiny, workload):
    """The reference one precision below the configuration's (float8 where
    it states bfloat16), in the program's place, is judged not correct by
    the run's own judgement; the program's call, by the same, correct."""
    r = bench._Runner(bench.Spec(tiny), workload, SEED, "cpu")
    with torch.inference_mode():
        r.setup()
        c = r.serve(0)
        n = r.compare(c, control=True)
    lim = check.limits(tiny, workload)
    ctl = n["control"]
    assert set(ctl) == {"gap", "logit_err", "token_mismatch", "row_gap", "row_err", "row_mismatch"}
    correct, failed, shown = check.judge([ctl], lim)
    assert not correct and failed > 0, (shown, lim)
    assert check.judge([n], lim)[:2] == (True, 0)
