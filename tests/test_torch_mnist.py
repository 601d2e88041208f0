"""PyTorch port vs JAX package: the paper's MNIST experiment and the data
pipelines, on the CPU.

The synthetic MNIST arrays and the token batches must be equal
(``np.array_equal``), and so must the MLP's initial weights (the port draws
them through ``core.prng``). Three SGD steps on the same batches are held to
a test-side ``jax.value_and_grad`` of ``repro.train.mnist_mlp._forward``
(eager, so the QAT quantization codes agree): loss within 1e-6 of itself and
params within 1e-6 of their largest magnitude (float32 summation order),
float and QAT (``fake_quant`` + STE). ``evaluate`` at the chip geometry
(bit-plane, 4/4 bits, rows 16, 5-bit SAR) must give JAX's accuracy on the
same params, without noise and with the comparator noise of 100 MHz (the
draws equal ``jax.random``'s), with logits within 1e-5 of their largest
magnitude. The port's own training loop (one epoch's accuracy, the QAT
kernel calls) is checked in ``test_torch_train_loop.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cim_linear import CiMConfig as JCiM
from repro.core.noise import AnalogEnv as JEnv
from repro.data import TokenPipeline as JTokens
from repro.data import load_mnist_synth as j_load
from repro.train import mnist_mlp as J
from repro_torch.core import prng
from repro_torch.core.cim_linear import CiMConfig
from repro_torch.core.noise import AnalogEnv
from repro_torch.data import TokenPipeline, load_mnist_synth
from repro_torch.train import mnist_mlp as T

CHIP = dict(mode="bitplane", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False, ste=False)
QAT = dict(mode="fake_quant", a_bits=4, w_bits=4, adc_bits=5, rows=16, a_signed=False)


def _to_jax(params):
    return [{k: jnp.asarray(v.detach().numpy()) for k, v in lyr.items()} for lyr in params]


def test_mnist_synth_and_token_batches_equal_jax():
    for a, b in zip(load_mnist_synth(), j_load()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for kw in (dict(vocab=256, seq_len=32, global_batch=4, seed=3), dict(vocab=49152, seq_len=16, global_batch=8)):
        mine, ref = TokenPipeline(**kw), JTokens(**kw)
        for step, rank, size in ((0, 0, 1), (7, 1, 2), (123, 3, 4)):
            got, want = mine.batch(step, rank, size), ref.batch(step, rank, size)
            assert all(np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)


def test_init_is_bit_exact():
    for seed in (0, 5):
        for mine, ref in zip(T._init(prng.PRNGKey(seed, "cpu")), J._init(jax.random.PRNGKey(seed))):
            for k in ("w", "b"):
                assert np.array_equal(mine[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("qat", [None, QAT], ids=["float", "qat-fake_quant"])
def test_three_sgd_steps_match_jax(qat):
    x_tr, y_tr, _, _ = load_mnist_synth()
    order = np.random.default_rng(0).permutation(x_tr.shape[0])
    pt = T._init(prng.PRNGKey(0, "cpu"))
    pj = J._init(jax.random.PRNGKey(0))
    jcim, tcim = (JCiM(**qat), CiMConfig(**qat)) if qat else (None, None)
    lr = 5e-2
    for i in range(3):
        idx = order[i * 128 : (i + 1) * 128]

        def loss_fn(p):
            logits = J._forward(p, jnp.asarray(x_tr[idx]), jcim)
            return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(128), jnp.asarray(y_tr[idx])])

        lj, g = jax.value_and_grad(loss_fn)(pj)
        pj = jax.tree.map(lambda p, gi: p - lr * gi, pj, g)
        lt = T.sgd_step(pt, torch.from_numpy(x_tr[idx]), torch.from_numpy(y_tr[idx]), lr, tcim)
        assert float(lt) == pytest.approx(float(lj), rel=1e-6)
    for mine, ref in zip(pt, pj):
        for k in ("w", "b"):
            want = np.asarray(ref[k])
            np.testing.assert_allclose(mine[k].numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def trained():
    """Port params after one float epoch."""
    return T.train_mlp(epochs=1, device="cpu")[0]


def test_evaluate_at_chip_geometry_matches_jax(trained):
    """Noiseless, then with the comparator noise of 100 MHz (sigma ~0.2 of
    full scale: most codes move, so the draws must be JAX's), on the same
    48 images. The JAX side is jitted (its eager bit-plane walk compiles
    op by op for ~20 s); XLA's reciprocal rewrite of ``absmax / qmax``
    (ROADMAP C) could move a code, and would show here as a failure."""
    params, pj, n_eval = trained, _to_jax(trained), 48
    x = jnp.asarray(j_load()[2][:n_eval])
    y = j_load()[3][:n_eval]
    for env in (None, dict(freq_hz=100e6)):
        cj = JCiM(**CHIP)
        if env:
            cj = dataclasses.replace(cj, comparator_sigma=J.effective_sigma(JEnv(**env)))
        lj = jax.jit(lambda p, x, k: J._forward(p, x, cj, key=k))(pj, x, jax.random.PRNGKey(0))
        acc_j = float(jnp.mean(jnp.argmax(lj, -1) == jnp.asarray(y)))  # J.evaluate's line
        lt, _ = T._eval_logits(params, CiMConfig(**CHIP), AnalogEnv(**env) if env else None, n_eval, 0, "cpu")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5 * float(jnp.abs(lj).max()))
        assert float(torch.mean((torch.argmax(lt, -1) == torch.from_numpy(y)).float())) == acc_j, env
        if env is None:
            assert T.evaluate(params, CiMConfig(**CHIP), n_eval=n_eval, device="cpu") == acc_j
