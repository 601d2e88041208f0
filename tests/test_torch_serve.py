"""PyTorch port vs JAX package: batched serving, on the CPU.

Both ``serve_batch`` functions serve the reduced smollm-135m on the same
prompts and the same weights (the JAX init, converted by
``params_from_jax``); greedy decoding must pick the same tokens. The port
prefills with ``attn_impl="flash"`` (the kernel's plain version on the CPU),
the JAX package with ``attn_impl="blocked"``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.cim_linear import CiMConfig as JCiM
from repro.launch import serve as jserve
from repro_torch.configs import get_config, reduced
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.launch import serve as tserve
from repro_torch.models.weights import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize(
    "cim",
    [None, dict(mode="fake_quant", ste=False), dict(mode="bitplane", ste=False)],
    ids=["exact", "fake_quant", "bitplane"],
)
def test_serve_batch_tokens_match_jax(cim):
    cj = j_reduced(j_get_config("smollm-135m"))
    ct = dataclasses.replace(reduced(get_config("smollm-135m")), attn_impl="flash")
    if cim is not None:
        cj = dataclasses.replace(cj, cim=JCiM(**cim))
        ct = dataclasses.replace(ct, cim=CiMConfig(**cim))
    st_j = jserve.ServeSettings(batch=2, prompt_len=128, gen_len=4, seed=0)
    st_t = tserve.ServeSettings(batch=2, prompt_len=128, gen_len=4, seed=0)
    out_j = jserve.serve_batch(cj, st_j)
    np_params = jax.tree_util.tree_map(np.asarray, jserve.compiled_model(cj, 0)[1])
    out_t = tserve.serve_batch(
        ct, st_t, prompts=out_j["prompts"], device="cpu", params=params_from_jax(np_params, ct, "cpu")
    )
    np.testing.assert_array_equal(out_t["prompts"], out_j["prompts"])
    np.testing.assert_array_equal(out_t["generated"], out_j["generated"])


def test_serve_batch_outputs_and_seeded_init():
    cfg = dataclasses.replace(
        reduced(get_config("smollm-135m")), cim=CiMConfig(mode="fake_quant", ste=False)
    )
    st = tserve.ServeSettings(batch=3, prompt_len=16, gen_len=5, seed=1)
    out = tserve.serve_batch(cfg, st, device="cpu")
    assert {"prompts", "generated", "prefill_s", "decode_s", "decode_tok_s", "logits"} <= out.keys()
    assert out["prompts"].shape == (3, 16) and out["generated"].shape == (3, 5)
    assert out["generated"].min() >= 0 and out["generated"].max() < cfg.vocab
    assert out["logits"].shape == (3, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(out["logits"][..., : cfg.vocab]).all())
    assert out["decode_tok_s"] > 0
    # compiled_model caches the seeded weights: a second call serves the same tokens
    again = tserve.serve_batch(cfg, st, device="cpu")
    np.testing.assert_array_equal(again["generated"], out["generated"])
    assert tserve.compiled_model(cfg, 1, "cpu") is tserve.compiled_model(cfg, 1, "cpu")


def test_serve_cli_on_cpu(capsys):
    tserve.main([
        "--arch", "smollm-135m", "--reduced", "--batch", "2", "--prompt-len", "8",
        "--gen-len", "3", "--cim", "fake_quant", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "[serve] smollm-135m on cpu: prefill" in out
    assert "sample generation" in out


def test_serve_cli_bitplane_on_cpu(capsys):
    tserve.main([
        "--arch", "smollm-135m", "--reduced", "--batch", "2", "--prompt-len", "8",
        "--gen-len", "2", "--cim", "bitplane", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "[serve] smollm-135m on cpu: prefill" in out
    assert "sample generation" in out
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "smollm-135m", "--cim", "analog", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-130m", "zamba2-7b"])
def test_serve_cli_model_families_on_cpu(capsys, arch):
    """The CLI serves the MoE, Mamba2 and hybrid families (reduced, with
    ``fake_quant`` linears)."""
    tserve.main([
        "--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
        "--gen-len", "3", "--cim", "fake_quant", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu: prefill" in out
    assert "sample generation" in out


def test_serve_cli_moe_fabric_on_cpu(capsys):
    """``--fabric hybrid`` on an MoE arch: the rollup maps the routers and
    the experts' projections, and the batching line carries the cost."""
    tserve.main([
        "--arch", "moonshot-v1-16b-a3b", "--reduced", "--batch", "2", "--prompt-len", "8",
        "--gen-len", "2", "--fabric", "hybrid", "--fabric-arrays", "60", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "[serve] fabric exec backend: sequential" in out
    assert "[serve] batch 2x10 tok on 1 chip(s) [sequential]" in out
    assert "| layer1.router |" in out and "| layer0.expert0.down_proj |" in out
    assert "[serve] moonshot-v1-16b-a3b on cpu: prefill" in out


def test_serve_cli_obs_flags_match_jax(tmp_path, monkeypatch, capsys):
    """``--obs-log`` and ``--obs-metrics-out`` on a reduced fabric serve: the
    Prometheus exposition holds the JAX CLI's metric names and the JSONL log
    its event and span names, and the port's spans inside the serve path;
    ``--obs-metrics`` prints the exposition."""
    import json

    argv = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--prompt-len", "8", "--gen-len", "3",
            "--cim", "fake_quant", "--fabric", "hybrid"]
    runs = {}
    for tag in ("jax", "port"):
        log, prom = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.prom"
        flags = argv + ["--obs-log", str(log), "--obs-metrics-out", str(prom)]
        if tag == "jax":
            monkeypatch.setattr("sys.argv", ["serve"] + flags)
            jserve.main()
        else:
            tserve.main(flags + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert f"[serve] obs JSONL event log: {log}" in out and f"[serve] obs metrics exposition: {prom}" in out
        assert "[serve] obs batch 2x11 tok on 1 chip(s) [sequential]" in out
        names = sorted({line.split()[2] for line in prom.read_text().splitlines() if line.startswith("# TYPE")})
        events = sorted({json.loads(line)["name"] for line in log.read_text().splitlines()})
        runs[tag] = names, events
    # the port's spans inside the serve path, which the JAX package does not record, come on top
    port_only = {"serve.decode_step", "layer.attention", "layer.mlp", "layer.unembed", "cim.quantize", "cim.matmul"}
    assert runs["port"][0] == runs["jax"][0]
    assert sorted(set(runs["port"][1]) - port_only) == runs["jax"][1] and port_only <= set(runs["port"][1])
    assert "fabric_ema_bits_total" in runs["port"][0] and "serve.request_summary" in runs["port"][1]
    tserve.main(argv + ["--device", "cpu", "--obs-metrics"])
    out = capsys.readouterr().out
    assert "[serve] obs metrics exposition:" in out and "# TYPE serve_requests_total counter" in out
