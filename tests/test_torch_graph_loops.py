"""The PyTorch port's per-node graph loop against the JAX package's, on
``model > 1`` meshes, on the CPU.

The port's loop sums a norm's squares per model-axis chip and adds the
parts in chip order, as its fused program's ``psum`` does, so that the
fused graph equals the loop bit for bit on every mesh
(``tests/test_torch_graph_scan.py``); JAX's loop sums the whole row. Here
the two loops are held to each other where that order differs, with the
tolerance and the count of differing quantization codes that
``tests/test_torch_graph.py`` holds them to on 1x1. The toy configs, their
numpy-seeded weights and the code counter come from that module.
"""

import numpy as np
import pytest

from test_torch_graph import (  # noqa: F401  (model_weights, x_np, _one_torch_thread are fixtures)
    CIMS, LOGIT_RTOL, _loops_and_codes, _one_torch_thread, _programs, model_weights, x_np,
)


@pytest.mark.parametrize("family,data,model,case", [
    ("dense", 1, 2, "fake_quant"), ("dense", 2, 2, "fake_quant"), ("moe", 1, 2, "fake_quant"),
    ("dense", 1, 2, "bitplane"), ("dense", 2, 2, "bitplane"),
])
def test_per_node_loop_matches_the_jax_loop_on_model_meshes(family, data, model, case, model_weights, x_np,
                                                            monkeypatch):
    """On a ``model > 1`` mesh the port's per-node loop sums a norm's
    squares per model-axis chip and adds the parts in chip order, as its
    fused program's ``psum`` does; JAX's loop sums the whole row. The two
    loops are held to each other there: logits within ``LOGIT_RTOL`` of
    max|logit| and at most 2 differing activation codes over every matmul
    boundary, as on 1x1 (the reordered sum moves a norm by an ulp at most,
    no more than the libm differences do; on these inputs 0 of 4608 codes
    differed and the logits within 1.9e-7 of max|logit|). The ``bitplane``
    JAX loop runs jitted: it is slow eagerly."""
    pj, pt = _programs(family, data, model, CIMS[case])
    wj, wt, *_ = model_weights[family, 1]
    yj, yt, n_codes, n_diff = _loops_and_codes(pj, pt, wj, wt, x_np, monkeypatch, jit=case == "bitplane")
    assert n_diff <= 2, f"{n_diff} of {n_codes} activation codes differ"
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=LOGIT_RTOL * np.abs(yj).max())
