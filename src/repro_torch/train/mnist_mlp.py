"""The paper's own evaluation workload on the PyTorch port: MNIST inference
through CiM arrays (counterpart of ``repro.train.mnist_mlp``).

A small MLP (256-128-64-10) is trained in float, or QAT-style with every
linear through the CiM fake-quant op and its straight-through estimator
(the fake-quant kernel in the forward pass on CUDA), then evaluated with
every linear routed through the bit-plane CiM + memory-immersed-ADC pipeline
at an operating point (ADC bits, search mode, clock frequency, supply
voltage): the accuracy trends of the paper's Fig. 7(c,d).

The initial weights and the ADC noise are drawn through ``core.prng`` as the
JAX package draws them through ``jax.random``, and the batches are shuffled
by the same numpy generator, so the port trains and evaluates what the JAX
package does on the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.cim_linear import CiMConfig, cim_matmul
from repro_torch.core.noise import AnalogEnv, effective_sigma
from repro_torch.data.mnist_synth import load_mnist_synth
from repro_torch.device import resolve_device

__all__ = ["train_mlp", "evaluate", "sgd_step"]

_SIZES = (256, 128, 64, 10)


def _init(key: torch.Tensor):
    """He-normal weights from ``key``'s splits, zero biases, on the key's
    device. JAX scales its float32 draw by a numpy float64, which it takes
    as a float32 scalar: the product is the float32 draw times
    ``fl32(sqrt(2 / fan))``."""
    params = []
    for i in range(len(_SIZES) - 1):
        key, k = prng.split(key).unbind(-2)
        scale = float(np.float32(np.sqrt(2.0 / _SIZES[i])))
        w = prng.normal(k, (_SIZES[i], _SIZES[i + 1])) * scale
        params.append({"w": w, "b": torch.zeros(_SIZES[i + 1], device=w.device)})
    return params


def _forward(params, x: torch.Tensor, cim: Optional[CiMConfig] = None, key=None) -> torch.Tensor:
    """Logits; with ``cim`` every linear goes through ``cim_matmul``, layer
    ``i`` drawing its ADC noise from the i-th split of ``key``."""
    h = x
    for i, lyr in enumerate(params):
        if cim is not None:
            k = None
            if key is not None:
                key, k = prng.split(key).unbind(-2)
            h = cim_matmul(h, lyr["w"], cim, key=k) + lyr["b"]
        else:
            h = h @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            h = F.relu(h)
    return h


def sgd_step(params, x: torch.Tensor, y: torch.Tensor, lr: float, qat_cim: Optional[CiMConfig] = None):
    """One SGD step on the mean softmax cross-entropy, in place
    (``p - lr * g`` as the JAX package computes it); returns the loss."""
    leaves = [lyr[k] for lyr in params for k in ("w", "b")]
    for t in leaves:
        t.requires_grad_(True)
    logits = _forward(params, x, qat_cim)
    loss = torch.mean(-F.log_softmax(logits, dim=-1)[torch.arange(x.shape[0], device=x.device), y.long()])
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t.copy_(t - lr * g)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach()


def train_mlp(epochs: int = 6, batch: int = 128, lr: float = 5e-2, seed: int = 0,
              qat_cim: Optional[CiMConfig] = None, device="cuda"):
    """Train the MLP on synthetic MNIST on ``device`` (CUDA unless the caller
    asks for the CPU); returns (params, float test accuracy)."""
    device = resolve_device(device)
    x_tr, y_tr, _, _ = load_mnist_synth()
    params = _init(prng.PRNGKey(seed, device))
    x_all = torch.from_numpy(x_tr).to(device)
    y_all = torch.from_numpy(y_tr).to(device)
    n = x_tr.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(device)
        for i in range(0, n, batch):
            idx = order[i : i + batch]
            sgd_step(params, x_all[idx], y_all[idx], lr, qat_cim)
    return params, evaluate(params, None, device=device)


def _eval_logits(params, cim: Optional[CiMConfig], env: Optional[AnalogEnv], n_eval: int, seed: int, device):
    """(logits of the first ``n_eval`` test images, their labels) on ``device``."""
    device = resolve_device(device)
    _, _, x_te, y_te = load_mnist_synth()
    x_te, y_te = x_te[:n_eval], y_te[:n_eval]
    if cim is not None and env is not None:
        cim = dataclasses.replace(cim, comparator_sigma=effective_sigma(env))
    params = [{k: v.to(device) for k, v in lyr.items()} for lyr in params]
    with torch.no_grad():
        logits = _forward(params, torch.from_numpy(x_te).to(device), cim, key=prng.PRNGKey(seed, device))
    return logits, torch.from_numpy(y_te).to(device)


def evaluate(
    params,
    cim: Optional[CiMConfig],
    env: Optional[AnalogEnv] = None,
    n_eval: int = 2048,
    seed: int = 0,
    device="cuda",
) -> float:
    """Test accuracy on ``device`` with linears routed through the CiM
    pipeline (``params`` are copied there).

    ``env`` injects the frequency/voltage-dependent comparator noise of
    core.noise into the ADC model (Fig. 7c,d operating-point sweeps)."""
    logits, y = _eval_logits(params, cim, env, n_eval, seed, device)
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))
