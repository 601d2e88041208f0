"""The general traffic generator: a traffic mix is a JSON file of
parameters under ``portbench/traffic/``, read by this one generator.

A mix of static batches (``"kind": "static_batches"``) is a closed loop of
whole ``serve_batch`` calls: call ``i`` serves ``batch`` prompts of length
``prompt_lens[i % len(prompt_lens)]`` and generates ``gen_len`` tokens. The
lengths are fixed by the file; the seed draws only the token ids, uniform
over the vocabulary, on the device. ``trace_calls`` calls run under the
profiler in a traced run, after the window; ``check_calls`` finished calls
are checked against the reference (one with the longest prompt among them).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Call", "load", "call", "cycle", "prompts", "sub_seed"]

KINDS = ("static_batches",)


class Call(NamedTuple):
    index: int
    batch: int
    prompt_len: int
    gen_len: int


def load(path) -> dict:
    t = json.loads(Path(path).read_text())
    if t.get("kind") not in KINDS:
        raise ValueError(f"{path}: traffic kind {t.get('kind')!r} is not one of {KINDS}")
    for key in ("batch", "prompt_lens", "gen_len", "trace_calls", "check_calls"):
        if key not in t:
            raise ValueError(f"{path}: missing {key!r}")
    if t["gen_len"] < 1 or t["batch"] < 1 or not t["prompt_lens"]:
        raise ValueError(f"{path}: batch, gen_len and prompt_lens must be positive")
    return t


def cycle(traffic: dict) -> int:
    """Calls in one cycle of the mix's lengths: a window is whole cycles."""
    return len(traffic["prompt_lens"])


def call(traffic: dict, index: int) -> Call:
    lens = traffic["prompt_lens"]
    return Call(index, traffic["batch"], lens[index % len(lens)], traffic["gen_len"])


def sub_seed(seed: int, *words: int) -> int:
    """A 63-bit seed for one purpose, drawn from the run's ``--seed`` (any
    whole number) and the purpose's words."""
    ss = np.random.SeedSequence([seed % (1 << 64), *words])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def prompts(c: Call, seed: int, vocab: int, device, stream: int = 0) -> torch.Tensor:
    """The (batch, prompt_len) int32 token ids of call ``c``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, stream, c.index))
    return torch.randint(0, vocab, (c.batch, c.prompt_len), generator=gen, device=device, dtype=torch.int32)
