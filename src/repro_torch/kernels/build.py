"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers), so
it compiles in seconds. It is built at first use, for ``sm_90a`` (Hopper),
into ``build/repro_torch_kernels/`` at the repository root, under a file name
keyed by a hash of its source and flags: an edited source is rebuilt, an
unchanged one is loaded as it is. Several sources build in parallel, one
``nvcc`` process each (:func:`build`).

Nothing here falls back: without ``nvcc`` or on a failed compile the caller
gets an exception, never a plain-PyTorch substitute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load", "find_nvcc", "build_dir"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("cim_matmul_fq", "flash_attention", "cim_matmul_bp", "adc_quant")
# No --use_fast_math: the CiM and ADC kernels' divides must stay IEEE-exact.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict = {}  # name -> ctypes.CDLL, loaded once per process
DEFAULT_CUDA_HOME = "/usr/local/cuda"


def build_dir() -> Path:
    """``build/repro_torch_kernels/`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    :data:`DEFAULT_CUDA_HOME`. Raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME, {DEFAULT_CUDA_HOME}): the port's CUDA "
        "kernels cannot be built, and CUDA tensors never fall back to plain PyTorch"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in ``names`` that is not built yet, all in
    parallel; returns ``{name: path of the shared library}``. The ``ptxas``
    report (registers, shared memory, spills) of each build lands beside its
    library as ``<library>.log``."""
    paths = {name: _lib_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LIBS[name] = lib
    return lib
