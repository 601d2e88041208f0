"""End-to-end LM training on the port (counterpart of the JAX package's
``examples/train_lm.py``): a ~20M-parameter smollm-family model for a few
hundred steps with checkpoints, the watchdog and supervised restart.

As in the JAX package, a second run on a checkpoint directory that already
holds ``--steps`` resumes there, trains no step and fails on its empty loss
list; the supervisor retries twice and raises.

Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--tiny] [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, reduced
from repro_torch.device import resolve_device
from repro_torch.ft.watchdog import run_with_restart
from repro_torch.launch.train import TrainSettings, train

__all__ = ["main", "run", "example_config"]


def example_config(tiny: bool = False):
    """``--tiny``: smollm-135m's ``reduced`` config (2 layers, d 64); else
    ~20M parameters of the same family, scaled to a CPU's budget."""
    if tiny:
        return reduced(ARCHS["smollm-135m"])
    return reduced(
        ARCHS["smollm-135m"],
        n_layers=6, d_model=256, d_ff=768, vocab=8192,
        n_heads=4, n_kv_heads=2, head_dim=64,
    )


def run(steps: int = 200, tiny: bool = False, ckpt_dir: str = "results/example_ckpt",
        device="cuda") -> dict:
    """Train under ``run_with_restart`` on ``device``; returns ``train``'s
    dict of the run that finished."""
    device = resolve_device(device)
    cfg = example_config(tiny)
    n = cfg.n_params()
    print(f"training {cfg.name}-example ({n/1e6:.1f}M params) for {steps} steps")

    st = TrainSettings(
        steps=steps, batch=8, seq=256, lr=1e-3, warmup=20,
        ckpt_dir=ckpt_dir, ckpt_every=50, log_every=10,
    )
    done = []

    def attempt(resume):
        out = train(cfg, st, device=device, resume=resume)
        print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
              f"({out['wall_s']:.0f}s, {st.batch * st.seq * steps / out['wall_s']:.0f} tok/s)")
        done.append(out)
        return st.steps

    run_with_restart(attempt, max_restarts=2)
    return done[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true", help="2-layer d=64 config")
    ap.add_argument("--ckpt-dir", default="results/example_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(steps=args.steps, tiny=args.tiny, ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
