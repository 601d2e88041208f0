"""The benchmark's description: every cell's configuration, traffic and
metric files resolve; ``BENCHMARK.json`` keeps to its contract; a metric or
a traffic mix added as a file is found with no edit."""

from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import bench, traffic

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_ENDS = ("_size", "_dim", "_rank", "_channels", "_state", "_headdim", "_expand", "_per_tok")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits its day: 2 + 14 x 24 runs of run_seconds + 60 s, compiles, spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 0 < len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves(w):
    spec = bench.Spec(ROOT)
    conf = spec.config(w["config"])
    mix = spec.traffic(w["traffic"])
    assert w["chips"] == 1
    assert traffic.cycle(mix) >= 1 and mix["check_calls"] >= 1 and mix["trace_calls"] >= 1
    assert all(s % 128 == 0 for s in mix["prompt_lens"])  # the flash prefill takes whole 128-query blocks
    assert conf["run"]["name"] == w["config"]
    reported = spec.metrics(w["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert spec.metrics(w["name"], "per_layer")


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_its_reader(m):
    mod = bench.load_metric(ROOT, m["name"])
    assert callable(mod.read)
    if "layer" in m:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    f = ROOT / c["file"]
    assert f.is_file() and f.parts[len(ROOT.parts)] == "portbench"
    conf = json.loads(f.read_text())
    assert set(c["reduced"]) == set(conf["reduced"])
    for key in c["reduced"]:
        assert NAME.match(key) and not key.endswith(WIDTH_ENDS) and "intermediate" not in key, key
    assert conf["run"]["cim"]["mode"] == "fake_quant" and conf["run"]["compute_dtype"] == "bfloat16"


def test_added_metric_and_traffic_are_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "metrics" / "calls_in_window.py").write_text(
        'LAYER = "serve: launch/serve.py serve_batch"\nMOVES = "gen_tok_s"\n\n\ndef read(rec):\n'
        "    return float(len(rec.calls))\n")
    mix = json.loads((ROOT / "portbench" / "traffic" / "generate-b128-p128-g128.json").read_text())
    mix.update(batch=64, gen_len=256)
    (tmp_path / "portbench" / "traffic" / "generate-b64-p128-g256.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": "zamba2-7b.generate-long", "config": "zamba2-7b",
                              "traffic": "generate-b64-p128-g256", "chips": 1, "why": "longer answers"})
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher", "source": "host_clock",
                              "layer": "serve: launch/serve.py serve_batch", "moves": "gen_tok_s",
                              "workloads": ["zamba2-7b.generate-long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    s = bench.Spec(tmp_path)
    assert s.traffic("generate-b64-p128-g256")["gen_len"] == 256
    assert [m["name"] for m in s.metrics("zamba2-7b.generate-long", "per_layer")] == ["calls_in_window"]
    assert bench.load_metric(tmp_path, "calls_in_window").read(type("R", (), {"calls": [1, 2]})) == 2.0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


BENCH_FILES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert not roots & {"jax", "jaxlib", "flax", "repro"}, path


YARDSTICK = sorted((ROOT / "portbench" / "reference").glob("*.py")) + [
    ROOT / "portbench" / n for n in ("work.py", "peaks.py", "check.py", "readers.py", "trace.py", "traffic.py", "weights.py")]


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(ROOT)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert not {m.split(".")[0] for m in _imports(path)} & {"repro_torch"}, path
