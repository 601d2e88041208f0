"""Quickstart: the paper's pipeline end to end, on the port (counterpart of the
JAX package's ``examples/quickstart.py``).

Trains the MNIST MLP in float, then evaluates it with every linear routed
through bit-plane CiM arrays digitized by the memory-immersed ADC, symmetric
SAR and asymmetric SAR (Fig. 4), under the comparator noise of a 10 MHz,
1.0 V operating point, and prints the area/energy ledger of Table I. The
rows are the JAX script's: its docstring also names a hybrid Flash+SAR row,
which its table does not run.

Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core.cim_linear import CiMConfig, digitization_stats
from repro_torch.core.energy_area import energy_pj, table1
from repro_torch.core.noise import AnalogEnv
from repro_torch.device import resolve_device
from repro_torch.train.mnist_mlp import evaluate, train_mlp

__all__ = ["main", "run"]


def run(epochs: int = 5, n_eval: int = 1024, device="cuda") -> dict:
    """The walkthrough on ``device``; returns the float accuracy and each
    row's accuracy. ``epochs`` and ``n_eval`` default to the JAX script's."""
    device = resolve_device(device)
    print("== training float MLP on synthetic MNIST ==")
    params, float_acc = train_mlp(epochs=epochs, device=device)
    print(f"float test accuracy: {float_acc:.3f}\n")

    chip = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16,
                a_signed=False, ste=False)
    configs = {
        "ideal (no CiM)": None,
        "CiM + symmetric SAR (5 cmp)": CiMConfig(search="sar", **chip),
        "CiM + asymmetric SAR (~3.7 cmp)": CiMConfig(search="sar_asym", **chip),
    }
    print("== inference through memory-immersed digitization ==")
    accs = {}
    for name, cim in configs.items():
        acc = evaluate(params, cim, env=AnalogEnv(freq_hz=10e6, vdd=1.0), n_eval=n_eval, device=device)
        if cim is not None:
            d = digitization_stats(cim, 1024, 256, 128)
            e = energy_pj("in_memory_asym" if cim.search == "sar_asym" else "in_memory", 5)
            extra = f"  E/conv={e:.1f} pJ, E[cmp]={d['expected_comparisons_per_conversion']:.2f}"
        else:
            extra = ""
        print(f"  {name:34s} acc={acc:.3f}{extra}")
        accs[name] = acc

    print("\n== Table I (measured-anchor area/energy model) ==")
    for style, d in table1().items():
        print(f"  {style:10s} {d['tech']:>5s}  {d['area_um2']:>9.1f} um^2  {d['energy_pj']:>7.2f} pJ")
    return {"float_acc": float_acc, "acc": accs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
