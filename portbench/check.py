"""The comparison that decides ``correct``: what the timed path served,
against the plain reference run over the same prompts and served tokens.

Numbers of each checked call; a workload's
``portbench/limits/<workload>.json`` names those it holds to a limit:

* ``gap``: the widest gap, over every served token of the call, by which
  the served token's reference logit lies below the reference's best at
  that position (0 where the program served the reference's first choice).
* ``logit_err``: the widest, over the call's requests, of the relative
  error of the logits the call returned (its last step's): the norm of the
  difference over the norm of the reference's logits about their mean.
* ``token_mismatch``: requests whose last served token is not the first
  choice of the logits the call returned (an exact check, limit 0).

A reading that is not a number (NaN logits) passes no limit.

The reference rounds to the configuration's compute dtype where the
program holds values in it. The control is the reference at the precision
below (float8 e4m3 where the configuration computes in bfloat16) put in the
program's place: its tokens are its own first choices at each position of
the same prompts and served tokens, its logits its own, and its numbers
are judged as the program's are.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from portbench.reference import Reference

__all__ = ["follow", "limits", "judge", "BELOW"]

# the precision below each compute dtype a configuration may state: the control's
BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row: |got - want| / |want - mean(want)| (2-norms over the vocabulary)."""
    spread = (want - want.mean(dim=-1, keepdim=True)).norm(dim=-1)
    return (got - want).norm(dim=-1) / spread


def _numbers(row_gap: torch.Tensor, row_err: torch.Tensor, row_mismatch: torch.Tensor) -> dict:
    """A call's numbers from its per-request readings (a NaN reading makes
    the call's number NaN)."""
    return {"gap": float(row_gap.max()), "logit_err": float(row_err.max()),
            "token_mismatch": float(row_mismatch.sum()),
            "row_gap": row_gap.cpu(), "row_err": row_err.cpu(), "row_mismatch": row_mismatch.cpu()}


def follow(run: dict, params: dict, prompts: torch.Tensor, served: torch.Tensor, prog_last: torch.Tensor,
           control: bool = False) -> dict:
    """Numbers of one served call. ``served`` (B, G) are the tokens the call
    served, ``prog_last`` (B, V) the logits it returned. With ``control``
    also the control's numbers, in the same form, under ``"control"``: its
    tokens are its own first choices, its logits its own last step's."""
    vocab = run["vocab"]
    dt = run["compute_dtype"]
    refs = [Reference(run, params, dt)] + ([Reference(run, params, BELOW[dt])] if control else [])
    gen_len = served.shape[1]
    with torch.inference_mode():
        logits = [r.prefill(prompts, gen_len)[:, :vocab] for r in refs]
        row_gap = torch.zeros(served.shape[0], device=prompts.device)
        row_cgap = torch.zeros_like(row_gap)
        for i in range(gen_len):
            ref = logits[0]
            best = ref.max(dim=-1).values
            tok = served[:, i].long()
            row_gap = torch.maximum(row_gap, best - ref.gather(1, tok[:, None])[:, 0])
            if control:
                ctok = logits[1].argmax(dim=-1)
                row_cgap = torch.maximum(row_cgap, best - ref.gather(1, ctok[:, None])[:, 0])
            if i < gen_len - 1:
                logits = [r.step(tok) for r in refs]
        err = _rel_err(prog_last[:, :vocab].float(), logits[0])
        # the last token served is the first choice of the logits the call returned
        mismatch = (prog_last[:, :vocab].argmax(dim=-1) != served[:, -1].long()).float()
        out = _numbers(row_gap, err, mismatch)
        if control:
            cmismatch = (logits[1].argmax(dim=-1) != ctok).float()
            out["control"] = _numbers(row_cgap, _rel_err(logits[1], logits[0]), cmismatch)
    return out


def limits(root: Path, workload: str) -> dict:
    """``{number: limit}`` of a workload, or ``{}`` where none is set."""
    path = Path(root) / "portbench" / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: float(v) for k, v in json.loads(path.read_text())["limits"].items()}


def _widest(values) -> float:
    """The largest of ``values``, NaN where any is NaN (``max`` would drop it)."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def judge(numbers: list, lim: dict) -> tuple:
    """``(correct, failed requests, {name: [widest reading, limit]})`` of the
    checked calls' numbers. No limit, no pass; a NaN reading passes none and
    is shown as the string ``"nan"``."""
    widest = {name: _widest(n[name] for n in numbers) for name in lim}
    failed = 0
    for n in numbers:
        bad = torch.zeros_like(n["row_gap"], dtype=torch.bool)
        for name, row in (("gap", "row_gap"), ("logit_err", "row_err"), ("token_mismatch", "row_mismatch")):
            if name in lim:
                bad |= ~(n[row] <= lim[name])  # NaN is not within the limit
        failed += int(bad.sum())
    correct = bool(lim) and all(widest[name] <= limit for name, limit in lim.items())
    shown = {name: [w if math.isfinite(w) else str(w), lim[name]] for name, w in widest.items()}
    return correct, failed, shown
