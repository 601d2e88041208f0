"""Atomic, async checkpoints of trees of tensors (counterpart of
``repro.checkpoint.ckpt``), in the JAX package's layout:

  <dir>/step_000123/
    manifest.json        — step, flat keys, shapes, dtypes
    arrays.npz           — one entry per leaf, named by its flat path

Flat keys are the JAX package's (``tree.path_key``: dict keys, list indices,
``.field`` for a NamedTuple), so a float32 checkpoint written by either
package restores in the other. numpy has no bfloat16, so a bfloat16 leaf is
stored as its uint16 bit patterns with ``"bfloat16"`` in the manifest and
restores bit for bit here (the JAX package's ``restore`` does not read
such a leaf back as bfloat16).

  * atomic: written to ``step_X.tmp`` and then renamed, so a crash during
    a save never leaves a partial latest checkpoint;
  * ``keep_last`` newest checkpoints kept, older ones removed;
  * async: :class:`Checkpointer` copies the tree to the host at once and
    writes it in a background thread, overlapping I/O with training.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path, path_key

__all__ = ["save", "save_async", "restore", "latest_step", "Checkpointer"]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        a = t.numpy().copy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _flatten(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {path_key(p): _host(leaf) for p, leaf in leaves_with_path(tree)}


def _write(ckpt_dir: Path, step: int, flat: dict, keep_last: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    tmp = ckpt_dir / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in flat.items()},
    }
    np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in flat.items()})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish

    steps = sorted(p for p in ckpt_dir.glob("step_*") if not p.name.endswith(".tmp"))
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def save(ckpt_dir: str | Path, step: int, tree: Any, keep_last: int = 3) -> Path:
    """Write ``tree`` as checkpoint ``step`` of ``ckpt_dir``; returns its
    directory."""
    return _write(Path(ckpt_dir), step, _flatten(tree), keep_last)


class Checkpointer:
    """Async saves: the host copy is taken at once, the write runs in a
    background thread; :meth:`wait` joins it and raises what it raised."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any):
        self.wait()
        flat = _flatten(tree)  # host snapshot now

        def _run():
            try:
                _write(self.dir, step, flat, self.keep_last)
            except BaseException as e:  # noqa: BLE001 — handed to wait(), which re-raises it
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()


def save_async(ckpt_dir, step, tree, keep_last: int = 3) -> Checkpointer:
    c = Checkpointer(ckpt_dir, keep_last)
    c.save_async(step, tree)
    return c


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*") if not p.name.endswith(".tmp")
    )
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int, like: Any) -> Any:
    """Checkpoint ``step`` in the structure of ``like``, each leaf a tensor
    on the device of ``like``'s leaf at that path."""
    path = Path(ckpt_dir) / f"step_{step:09d}"
    keys = json.loads((path / "manifest.json").read_text())["keys"]
    with np.load(path / "arrays.npz") as data:

        def leaf(key: str, like_leaf):
            a = np.array(data[key])
            if keys[key]["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            if list(t.shape) != keys[key]["shape"]:
                raise ValueError(f"checkpoint leaf {key!r}: shape {list(t.shape)}, manifest {keys[key]['shape']}")
            return t.to(like_leaf.device) if isinstance(like_leaf, torch.Tensor) else t

        return map_with_path(leaf, like)
