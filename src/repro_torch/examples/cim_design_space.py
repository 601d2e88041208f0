"""Design-space sweep on the port (counterpart of the JAX package's
``examples/cim_design_space.py``): ADC style x precision -> area / energy /
latency / MNIST accuracy, the Fig. 7 exploration in one table.

The accuracy column is the noiseless bit-plane evaluation at the chip
geometry (4/4 bits, rows 16). As in the JAX script, the
``in_memory_hybrid`` rows evaluate with ``search="sar"``, so their accuracy
is the ``in_memory`` rows'.

Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.examples.cim_design_space [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core.cim_linear import CiMConfig
from repro_torch.core.energy_area import area_um2, energy_pj, latency_cycles
from repro_torch.device import resolve_device
from repro_torch.train.mnist_mlp import evaluate, train_mlp

__all__ = ["main", "run"]


def run(epochs: int = 5, n_eval: int = 512, device="cuda") -> dict:
    """The sweep on ``device``; returns the float accuracy and the accuracy
    of each ``(style, bits)``. ``epochs`` and ``n_eval`` default to the JAX
    script's."""
    device = resolve_device(device)
    params, float_acc = train_mlp(epochs=epochs, device=device)
    print(f"float accuracy: {float_acc:.3f}")
    print(f"{'style':18s} {'bits':>4s} {'area um2':>9s} {'E pJ':>7s} "
          f"{'lat cyc':>8s} {'accuracy':>8s}")
    accs = {}
    for style in ("in_memory", "in_memory_asym", "in_memory_hybrid"):
        for bits in (3, 4, 5):
            cim = CiMConfig(
                mode="bitplane", a_bits=4, w_bits=4, adc_bits=bits, rows=16,
                a_signed=False, ste=False,
                search="sar_asym" if style == "in_memory_asym" else "sar",
            )
            acc = evaluate(params, cim, n_eval=n_eval, device=device)
            print(f"{style:18s} {bits:4d} {area_um2(style, bits):9.1f} "
                  f"{energy_pj(style, bits):7.1f} {latency_cycles(style, bits):8.2f} "
                  f"{acc:8.3f}")
            accs[(style, bits)] = acc
    return {"float_acc": float_acc, "acc": accs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
