"""Rules of the PyTorch port: no JAX, no quiet CPU fallback, no quiet
kernel fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.examples import quickstart, serve_lm
from repro_torch.kernels import adc_quant as aq
from repro_torch.kernels import build
from repro_torch.kernels import cim_matmul as cmm
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import ServeSettings, serve_batch
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.kernels, repro_torch.obs\n"
        "import repro_torch.models.weights, repro_torch.kernels.flash_attention\n"
        "import repro_torch.core.adc, repro_torch.core.search_tree, repro_torch.core.mav_stats\n"
        "import repro_torch.kernels.adc_quant\n"
        "import repro_torch.core.prng, repro_torch.core.noise, repro_torch.core.energy_area\n"
        "import repro_torch.core.schedule, repro_torch.core.cim_array\n"
        "import repro_torch.fabric, repro_torch.fabric.report\n"
        "import repro_torch.data, repro_torch.train, repro_torch.optim, repro_torch.optim.grad_compression\n"
        "import repro_torch.checkpoint, repro_torch.ft, repro_torch.launch.train, repro_torch.tree\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.serve_lm\n"
        "import repro_torch.examples.train_lm, repro_torch.examples.cim_design_space\n"
        "print('imported')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


def test_default_device_raises_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    cfg = reduced(get_config("smollm-135m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_batch(cfg, ServeSettings(batch=1, prompt_len=4, gen_len=2))
    # the walkthroughs refuse before any work: nothing trained, served or printed
    for example in (quickstart, serve_lm):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            example.main([])
    assert capsys.readouterr().out == ""


def test_wrappers_never_fall_back_from_a_non_cpu_tensor():
    """Only CPU tensors take the plain version: any other device goes to the
    kernel path, which raises here instead of computing in plain PyTorch."""
    before = (cmm.launches, fa.launches, cmm.bp_launches, aq.launches)
    x = torch.zeros((4, 32), dtype=torch.int8, device="meta")
    w = torch.zeros((32, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cmm.cim_matmul_fq(x, w, rows=16, step=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        cmm.cim_matmul_fq(torch.zeros((4, 32), dtype=torch.int8), w, rows=16, step=1.0)
    q = torch.zeros((1, 2, 128, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)
    bp = dict(rows=16, adc_bits=5, a_bits=8, w_bits=8)
    xu, wu = x.to(torch.uint8), w.to(torch.uint8)
    with pytest.raises(ValueError, match="CUDA device"):
        cmm.cim_matmul_bp(xu, wu, **bp)
    with pytest.raises(ValueError, match="CUDA device"):
        cmm.cim_matmul_bp(torch.zeros((4, 32), dtype=torch.uint8), wu, **bp)
    with pytest.raises(ValueError, match="CUDA device"):
        aq.adc_quant(torch.zeros((4, 32), device="meta"), bits=5)
    assert (cmm.launches, fa.launches, cmm.bp_launches, aq.launches) == before


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    before = (cmm.launches, fa.launches, cmm.bp_launches, aq.launches)
    xi = torch.randint(-128, 128, (8, 32), generator=torch.Generator().manual_seed(0)).float()
    wi = torch.randint(-128, 128, (32, 8), generator=torch.Generator().manual_seed(1)).float()
    torch.testing.assert_close(
        cmm.cim_matmul_fq(xi, wi, rows=16, step=10922.5),
        cmm.cim_matmul_fq_plain(xi, wi, rows=16, step=10922.5),
        rtol=0, atol=0,
    )
    q = torch.randn((1, 2, 128, 32), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(fa.flash_attention(q, q, q), fa.flash_attention_plain(q, q, q), rtol=0, atol=0)
    bp = dict(rows=16, adc_bits=5, a_bits=8, w_bits=8)
    torch.testing.assert_close(cmm.cim_matmul_bp(xi, wi, **bp), cmm.cim_matmul_bp_plain(xi, wi, **bp), rtol=0, atol=0)
    v = torch.rand((8, 40), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(aq.adc_quant(v, bits=5, vdd=0.8), aq.adc_quant_plain(v, bits=5, vdd=0.8), rtol=0, atol=0)
    assert (cmm.launches, fa.launches, cmm.bp_launches, aq.launches) == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert set(build.SOURCES) == {"cim_matmul_fq", "flash_attention", "cim_matmul_bp", "adc_quant"}
    assert all((build.CSRC / f"{name}.cu").is_file() for name in build.SOURCES)
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """Here (no CUDA) and alone in a directory, the smoke exits non-zero and
    prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_kernel_times_fails_without_a_gpu():
    """The kernel timing script needs a card: here it exits non-zero and
    prints no numbers."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "kernel_times.py")], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert "device_ms" not in out.stdout
