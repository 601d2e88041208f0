"""A checkout of the benchmark cut to the port's ``reduced`` sizes, for the
CPU tests: the same files, each configuration's ``run`` group at the size
``repro_torch.configs.base.reduced`` gives it, short traffic."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def reduced_run(run: dict, dtype: str = "float32") -> dict:
    """``run`` at the port's reduced size of its architecture, in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced

    small = dataclasses.asdict(reduced(get_config(run["name"])))
    out = {k: (small[k] if k in small and k != "cim" else v) for k, v in run.items()}
    out.update(param_dtype=dtype, compute_dtype=dtype)
    return out


def tiny_root(tmp, dtype: str = "float32", prompt: int = 128, gen_len: int = 4, check_calls: int = 1,
              lens: int | None = None) -> Path:
    """A copy of the benchmark under ``tmp``: configurations at their reduced
    size in ``dtype``, every mix at batch 2, prompts of ``prompt`` and
    ``2 * prompt`` (the first ``lens`` of them, or as many as the mix has
    lengths, at most 2), at most ``gen_len`` tokens, one call traced and
    ``check_calls`` checked."""
    root = Path(tmp)
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for p in (root / "portbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["run"] = reduced_run(c["run"], dtype)
        p.write_text(json.dumps(c))
    for p in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(batch=2, prompt_lens=[prompt, 2 * prompt][: lens or len(t["prompt_lens"])],
                 gen_len=min(t["gen_len"], gen_len), trace_calls=1, check_calls=check_calls)
        p.write_text(json.dumps(t))
    return root
