"""The plain reference against the program on the CPU, at each
configuration's reduced float32 size: prefill logits, decode through the
caches, and decode against the reference's full forward."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import bench, check, weights
from portbench.reference import Reference
from portbench.tests.tiny import reduced_run

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("smollm-135m", "zamba2-7b")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name: str, dtype: str = "float32") -> dict:
    return reduced_run(json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["run"], dtype)


def _serve(run, params, prompts, gen_len, cim=True):
    from repro_torch.launch.serve import ServeSettings, serve_batch

    cfg = bench.port_config(run)
    if not cim:
        cfg = dataclasses.replace(cfg, cim=None)
    b, s = prompts.shape
    return serve_batch(cfg, ServeSettings(batch=b, prompt_len=s, gen_len=gen_len), prompts=prompts,
                       device="cpu", params=params)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_agree_with_the_program(name):
    run = _run(name)
    params = weights.make_params(run, 7, "cpu")
    prompts = torch.randint(0, run["vocab"], (2, 128), generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    with torch.inference_mode():
        out = _serve(run, params, prompts, gen_len=1)
        ref = Reference(run, params, "float32").prefill(prompts, 1)
        torch.testing.assert_close(out["logits"][:, -1, : run["vocab"]], ref[:, : run["vocab"]], rtol=1e-5, atol=1e-5)
        out = _serve(run, params, prompts, gen_len=4)
        n = check.follow(run, params, prompts, torch.as_tensor(out["generated"]), out["logits"][:, -1])
    assert n["gap"] == 0.0 and n["logit_err"] < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_reference_is_the_program_bit_for_bit_on_the_cpu(name):
    run = _run(name, "bfloat16")
    params = weights.make_params(run, 8, "cpu")
    prompts = torch.randint(0, run["vocab"], (2, 128), generator=torch.Generator().manual_seed(2), dtype=torch.int32)
    with torch.inference_mode():
        out = _serve(run, params, prompts, gen_len=3)
        n = check.follow(run, params, prompts, torch.as_tensor(out["generated"]), out["logits"][:, -1])
    assert n["gap"] == 0.0 and n["logit_err"] == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_through_the_caches_against_the_full_forward(name):
    """With plain products (the quantization scale is per call, so only then
    is a full forward the same model): each served step's logits equal the
    reference's forward over the prompt and the tokens served before it."""
    run = dict(_run(name), cim=dict(_run(name)["cim"], mode="exact"))
    params = weights.make_params(run, 9, "cpu")
    prompts = torch.randint(0, run["vocab"], (2, 128), generator=torch.Generator().manual_seed(3), dtype=torch.int32)
    gen_len = 4
    with torch.inference_mode():
        out = _serve(run, params, prompts, gen_len, cim=False)
        served = torch.as_tensor(out["generated"])
        for i in range(gen_len):
            seq = torch.cat([prompts, served[:, :i]], dim=1)
            full = Reference(run, params, "float32").prefill(seq, 1)[:, : run["vocab"]]
            assert torch.equal(full.argmax(-1), served[:, i].long())
        torch.testing.assert_close(out["logits"][:, -1, : run["vocab"]], full, rtol=1e-4, atol=1e-4)
