"""Procedural synthetic MNIST of the PyTorch port (a copy of
``repro.data.mnist_synth``: offline, no downloads; numpy only).

Digits 0–9 rendered from a classic 5×7 bitmap font, upscaled to 16×16, then
augmented with per-sample random shifts (±2 px), pixel dropout, and Gaussian
noise. Deterministic per (seed, split). An MLP reaches >95% accuracy — the
regime of the paper's Fig. 7(c,d) MNIST experiment; the *trend* of accuracy
vs ADC operating point is the reproduction target.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_mnist_synth", "IMG_DIM"]

IMG_DIM = 16 * 16

# 5x7 hex font, digits 0-9 (column-major bits, classic ROM font)
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph16(digit: int) -> np.ndarray:
    g = np.array([[int(c) for c in row] for row in _FONT[digit]], np.float32)
    # upscale 5x7 -> 10x14, then pad to 16x16 centered
    g = np.repeat(np.repeat(g, 2, axis=0), 2, axis=1)  # 14x10
    out = np.zeros((16, 16), np.float32)
    out[1:15, 3:13] = g
    return out


def load_mnist_synth(n_train: int = 8192, n_test: int = 2048, seed: int = 0):
    """Returns (x_train, y_train, x_test, y_test); x flattened to 256, in [0,1]."""
    glyphs = np.stack([_glyph16(d) for d in range(10)])

    def make(n, rng):
        y = rng.integers(0, 10, n)
        x = glyphs[y].copy()
        # random shift ±2 px
        sx = rng.integers(-2, 3, n)
        sy = rng.integers(-2, 3, n)
        for i in range(n):
            x[i] = np.roll(np.roll(x[i], sy[i], axis=0), sx[i], axis=1)
        # pixel dropout + noise + contrast jitter
        drop = rng.random(x.shape) < 0.05
        x = np.where(drop, 0.0, x)
        x = x * rng.uniform(0.7, 1.0, (n, 1, 1))
        x = x + 0.15 * rng.standard_normal(x.shape)
        return np.clip(x, 0, 1).reshape(n, -1).astype(np.float32), y.astype(np.int32)

    rng = np.random.default_rng(seed)
    x_tr, y_tr = make(n_train, rng)
    x_te, y_te = make(n_test, np.random.default_rng(seed + 1))
    return x_tr, y_tr, x_te, y_te
