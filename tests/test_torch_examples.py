"""The port's walkthrough scripts (``repro_torch.examples``: quickstart,
cim_design_space, serve_lm, train_lm) on the CPU at reduced sizes, against
the JAX package's ``examples/`` scripts: the same lines in the same format,
the deterministic columns (Table I, energy, area, latency, expected
comparisons, parameter counts) character for character, and the float MLP's
accuracy exactly. Every ``evaluate`` call of quickstart and cim_design_space
is recorded: its CiMConfig, operating point and ``n_eval`` equal the JAX
script's field for field, and the design space's noiseless ``in_memory``
accuracies equal JAX's forward on the same params. The JAX scripts' quirks are pinned as the reference's
behaviour: the ``in_memory_hybrid`` rows evaluate with ``search="sar"``, and
a second ``train_lm`` run on a finished checkpoint directory raises
``IndexError`` after two restarts."""

import dataclasses
import inspect
import math
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.core import energy_area as jea
from repro.core.cim_linear import CiMConfig as JaxCiMConfig
from repro.core.cim_linear import digitization_stats as jax_digitization_stats
from repro.core.noise import AnalogEnv as JaxAnalogEnv
from repro.data import load_mnist_synth as jax_load_mnist
from repro.train import mnist_mlp as jax_mnist
from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.examples import cim_design_space, quickstart, serve_lm, train_lm
from repro_torch.train.mnist_mlp import train_mlp

# the reduced sizes: one epoch; 16 test images, 8 through the noisy ADC (the
# threefry of the noisy evaluation costs ~0.6 s an image on one thread)
EPOCHS, N_EVAL, N_EVAL_NOISY = 1, 16, 8
CHIP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False, ste=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: the noisy bit-plane
    evaluation is many small ops, which slow down by two orders of magnitude
    when parallel test workers oversubscribe the cores with their threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_float_acc():
    """The JAX package's float MLP test accuracy after one epoch."""
    return float(jax_mnist.train_mlp(epochs=EPOCHS)[1])


@pytest.fixture(scope="module")
def port_mlp():
    """The port's float MLP after one epoch: quickstart and cim_design_space
    both train it, and it is trained once for both."""
    return train_mlp(epochs=EPOCHS, device="cpu")


def _train_once(monkeypatch, script, port_mlp):
    """``script.train_mlp`` answers its one call of the run with ``port_mlp``."""

    def trained(epochs, device):
        assert (epochs, device) == (EPOCHS, torch.device("cpu"))
        return port_mlp

    monkeypatch.setattr(script, "train_mlp", trained)


def _record_evaluate(monkeypatch, script):
    """Wrap ``script.evaluate`` so that each call's arguments (params, cim,
    env, n_eval, as passed) are kept; the call itself is unchanged."""
    calls, real = [], script.evaluate
    sig = inspect.signature(real)

    def recording(*args, **kw):
        calls.append(sig.bind(*args, **kw).arguments)
        return real(*args, **kw)

    monkeypatch.setattr(script, "evaluate", recording)
    return calls


def _asdict(cfg):
    return None if cfg is None else dataclasses.asdict(cfg)


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch, jax_float_acc, port_mlp):
    _train_once(monkeypatch, quickstart, port_mlp)
    calls = _record_evaluate(monkeypatch, quickstart)
    res = quickstart.run(epochs=EPOCHS, n_eval=N_EVAL_NOISY, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert res["float_acc"] == jax_float_acc
    # the JAX script's rows: ideal, then the chip geometry with symmetric and asymmetric SAR,
    # each under the comparator noise of 10 MHz, 1.0 V
    assert [_asdict(c["cim"]) for c in calls] == [
        None, *(dataclasses.asdict(JaxCiMConfig(search=s, **CHIP)) for s in ("sar", "sar_asym"))]
    assert all(_asdict(c["env"]) == dataclasses.asdict(JaxAnalogEnv(freq_hz=10e6, vdd=1.0))
               and c["n_eval"] == N_EVAL_NOISY for c in calls)
    acc = res["acc"]
    assert all(0.0 <= a <= 1.0 for a in acc.values())
    rows = [f"  {'ideal (no CiM)':34s} acc={acc['ideal (no CiM)']:.3f}"]
    for name, search, style in (("CiM + symmetric SAR (5 cmp)", "sar", "in_memory"),
                                ("CiM + asymmetric SAR (~3.7 cmp)", "sar_asym", "in_memory_asym")):
        d = jax_digitization_stats(JaxCiMConfig(search=search, **CHIP), 1024, 256, 128)
        rows.append(f"  {name:34s} acc={acc[name]:.3f}  E/conv={jea.energy_pj(style, 5):.1f} pJ, "
                    f"E[cmp]={d['expected_comparisons_per_conversion']:.2f}")
    table = [f"  {style:10s} {d['tech']:>5s}  {d['area_um2']:>9.1f} um^2  {d['energy_pj']:>7.2f} pJ"
             for style, d in jea.table1().items()]
    assert lines == [
        "== training float MLP on synthetic MNIST ==",
        f"float test accuracy: {jax_float_acc:.3f}",
        "",
        "== inference through memory-immersed digitization ==",
        *rows,
        "",
        "== Table I (measured-anchor area/energy model) ==",
        *table,
    ]


def test_cim_design_space_columns_equal_the_reference(capsys, monkeypatch, jax_float_acc, port_mlp):
    _train_once(monkeypatch, cim_design_space, port_mlp)
    calls = _record_evaluate(monkeypatch, cim_design_space)
    res = cim_design_space.run(epochs=EPOCHS, n_eval=N_EVAL, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert res["float_acc"] == jax_float_acc
    acc = res["acc"]
    assert all(0.0 <= a <= 1.0 for a in acc.values())
    # the JAX script's nine configs, noiseless, in its order
    jax_cims = {(style, bits): JaxCiMConfig(search="sar_asym" if style == "in_memory_asym" else "sar",
                                            **{**CHIP, "adc_bits": bits})
                for style in ("in_memory", "in_memory_asym", "in_memory_hybrid") for bits in (3, 4, 5)}
    assert [_asdict(c["cim"]) for c in calls] == [dataclasses.asdict(c) for c in jax_cims.values()]
    assert all(c.get("env") is None and c["n_eval"] == N_EVAL for c in calls)
    # the in_memory rows' accuracy is JAX's forward on the same params (jitted: its eager
    # bit-plane walk compiles op by op)
    params = [{k: jnp.asarray(v.detach().cpu().numpy()) for k, v in lyr.items()} for lyr in calls[0]["params"]]
    _, _, x_te, y_te = jax_load_mnist()
    x = jnp.asarray(x_te[:N_EVAL])
    for bits in (3, 4, 5):
        cj = jax_cims[("in_memory", bits)]
        logits = jax.jit(lambda p, x: jax_mnist._forward(p, x, cj))(params, x)
        assert acc[("in_memory", bits)] == float(jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(y_te[:N_EVAL])))
    want = [f"float accuracy: {jax_float_acc:.3f}",
            f"{'style':18s} {'bits':>4s} {'area um2':>9s} {'E pJ':>7s} {'lat cyc':>8s} {'accuracy':>8s}"]
    for style in ("in_memory", "in_memory_asym", "in_memory_hybrid"):
        for bits in (3, 4, 5):
            want.append(f"{style:18s} {bits:4d} {jea.area_um2(style, bits):9.1f} {jea.energy_pj(style, bits):7.1f} "
                        f"{jea.latency_cycles(style, bits):8.2f} {acc[(style, bits)]:8.3f}")
    assert lines == want
    # the reference evaluates the hybrid rows with search="sar": the in_memory rows' accuracy
    for bits in (3, 4, 5):
        assert acc[("in_memory_hybrid", bits)] == acc[("in_memory", bits)]


@pytest.mark.parametrize("cim", [False, True], ids=["exact", "cim"])
def test_serve_lm_lines_and_tokens(capsys, cim):
    cfg = serve_lm.example_config(cim)
    jax_cfg = jax_reduced(JAX_ARCHS["smollm-135m"], n_layers=4, d_model=128, d_ff=384)
    if cim:
        jax_cfg = dataclasses.replace(jax_cfg, cim=JaxCiMConfig(mode="fake_quant", adc_bits=8, rows=64, ste=False))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    out = serve_lm.main(["--device", "cpu", "--batch", "2", "--gen-len", "4"] + (["--cim"] if cim else []))
    lines = capsys.readouterr().out.splitlines()
    gen = out["generated"]
    assert gen.shape == (2, 4) and gen.min() >= 0 and gen.max() < cfg.vocab
    mode = re.escape("CiM fake-quant" if cim else "exact")
    assert re.fullmatch(rf"\[{mode}\] prefill \d+ ms, decode \d+\.\d tok/s", lines[0]), lines[0]
    assert lines[1:] == [f"  request {i}: {gen[i, :12].tolist()} ..." for i in range(2)]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "20M"])
def test_train_lm_config_and_parameter_count_equal_the_reference(tiny):
    smollm = JAX_ARCHS["smollm-135m"]
    jax_cfg = jax_reduced(smollm) if tiny else jax_reduced(
        smollm, n_layers=6, d_model=256, d_ff=768, vocab=8192, n_heads=4, n_kv_heads=2, head_dim=64)
    cfg = train_lm.example_config(tiny)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert f"{cfg.n_params() / 1e6:.1f}M" == f"{jax_cfg.n_params() / 1e6:.1f}M"


def test_train_lm_tiny_trains_then_fails_on_its_finished_checkpoint(tmp_path, capsys):
    argv = ["--tiny", "--steps", "3", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = train_lm.main(argv)
    lines = capsys.readouterr().out.splitlines()
    n = jax_reduced(JAX_ARCHS["smollm-135m"]).n_params()
    assert lines[0] == f"training smollm-135m-example ({n/1e6:.1f}M params) for 3 steps"
    assert re.fullmatch(r"loss: \d+\.\d{3} -> \d+\.\d{3} \(\d+s, \d+ tok/s\)", lines[-1]), lines[-1]
    assert not any(line.startswith("[ft] failure") for line in lines)
    assert latest_step(tmp_path) == 3
    assert len(out["losses"]) == 3 and all(math.isfinite(v) for v in out["losses"])
    # the reference's behaviour: the resumed run trains no step, its loss list is empty, and the
    # supervisor restarts twice before it raises
    with pytest.raises(IndexError):
        train_lm.main(argv)
    again = capsys.readouterr().out
    assert len(re.findall(r"^\[ft\] failure #\d+: IndexError", again, re.M)) == 2
