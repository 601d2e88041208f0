"""End-to-end training driver of the PyTorch port (counterpart of
``repro.launch.train``): data -> train step -> checkpoint/restart.

One device: the step is ``Model.loss_fn`` under autograd and the
configured optimizer (``optim.make_optimizer``), with microbatch gradient
accumulation (the JAX package's ``lax.scan`` over microbatches, as a loop
that adds the gradients in microbatch order); async atomic checkpoints of
the params and of the optimizer state, a watchdog with straggler detection,
supervised restart and the seekable token pipeline, so an interrupted run
resumed from its checkpoint continues as the uninterrupted one.

CLI (CPU-scale example):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.checkpoint.ckpt import Checkpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import divisor, resolve_device, synchronize
from repro_torch.ft.watchdog import Watchdog, run_with_restart
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, unflatten_like

__all__ = ["TrainSettings", "train", "build_step", "value_and_grad"]


@dataclasses.dataclass
class TrainSettings:
    steps: int = 50
    batch: int = 8
    seq: int = 128
    lr: float = 3e-4
    warmup: int = 10
    microbatches: int = 1  # gradient accumulation
    ckpt_dir: str = "results/ckpt"
    ckpt_every: int = 25
    keep_last: int = 3
    seed: int = 0
    log_every: int = 10


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``: grads in
    ``params``' structure, zeros for a leaf the loss does not reach."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, mets = loss_fn(unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in mets.items()}), unflatten_like(params, grads)


def build_step(model, st: TrainSettings):
    """``(opt_init, step_fn)``; ``step_fn(params, opt_state, batch, step)``
    returns ``(params, opt_state, metrics)``."""
    opt_init, opt_update = make_optimizer(model.config.optimizer)

    def train_step(params, opt_state, batch, step):
        if st.microbatches > 1:
            mb = {k: v.reshape(st.microbatches, -1, *v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), device=model.device)
            for i in range(st.microbatches):
                (loss_i, _), g = value_and_grad(model.loss_fn, params, {k: v[i] for k, v in mb.items()})
                grads = tree_map(torch.add, grads, g)
                loss = loss + loss_i
            n = divisor(st.microbatches, loss)
            grads = tree_map(lambda g: g / n, grads)
            loss, mets = loss / n, {}
        else:
            (loss, mets), grads = value_and_grad(model.loss_fn, params, batch)
        lr_t = warmup_cosine(step, st.lr, st.warmup, st.steps).to(model.device)
        new_params, new_opt, opt_mets = opt_update(grads, opt_state, params, lr_t)
        return new_params, new_opt, {"loss": loss, "lr": lr_t, **mets, **opt_mets}

    return opt_init, train_step


def train(
    cfg: ModelConfig,
    st: TrainSettings,
    device="cuda",
    resume: Optional[int] = None,
    stop_at: Optional[int] = None,
) -> dict:
    """Train ``cfg`` on ``device`` (CUDA unless the caller asks for the CPU)
    from seeded random weights, or from the latest checkpoint in
    ``st.ckpt_dir`` (``resume``: that step). ``stop_at`` simulates an
    interruption at that step while keeping the LR schedule defined by
    ``st.steps``. Returns the losses, per-step host seconds and params."""
    device = resolve_device(device)
    model = build_model(cfg, device)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=st.seq, global_batch=st.batch, seed=st.seed)
    opt_init, step_fn = build_step(model, st)

    params = model.init(torch.Generator(device=device).manual_seed(st.seed))
    opt_state = opt_init(params)
    start = 0
    ck = latest_step(st.ckpt_dir) if resume is None else resume
    if ck is not None:
        params = restore(st.ckpt_dir, ck, params)
        opt_state = restore(Path(st.ckpt_dir) / "opt", ck, opt_state)
        start = ck
        print(f"[train] resumed from step {ck}")

    ckpt = Checkpointer(st.ckpt_dir, st.keep_last)
    ckpt_opt = Checkpointer(Path(st.ckpt_dir) / "opt", st.keep_last)
    wd = Watchdog(Path(st.ckpt_dir) / "heartbeat.json")
    losses, step_s = [], []
    t0 = time.time()
    end = min(st.steps, stop_at) if stop_at is not None else st.steps
    for step in range(start, end):
        t_step = time.time()
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(step).items()}
        params, opt_state, mets = step_fn(params, opt_state, batch, step)
        synchronize(device)
        loss = float(mets["loss"])
        step_s.append(time.time() - t_step)
        losses.append(loss)
        wd.step(step, {"loss": loss})
        if step % st.log_every == 0 or step == st.steps - 1:
            print(f"[train] step {step}: loss {loss:.4f} lr {float(mets['lr']):.2e}")
        if (step + 1) % st.ckpt_every == 0 or step == end - 1:
            ckpt.save_async(step + 1, params)
            ckpt_opt.save_async(step + 1, opt_state)
    ckpt.wait()
    ckpt_opt.wait()
    return {
        "final_loss": losses[-1],
        "first_loss": losses[0],
        "losses": losses,
        "step_s": step_s,
        "wall_s": time.time() - t0,
        "params": params,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--max-restarts", type=int, default=2)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    st = TrainSettings(
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir,
    )

    def run(resume):
        out = train(cfg, st, device=args.device, resume=resume)
        print(
            f"[train] done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
            f"in {out['wall_s']:.1f}s"
        )
        return st.steps

    run_with_restart(run, max_restarts=args.max_restarts)


if __name__ == "__main__":
    main()
