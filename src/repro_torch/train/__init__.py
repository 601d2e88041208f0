"""Training workloads of the PyTorch port: the LM train loop lives in
``launch/train.py``; the paper's MNIST-CiM experiment lives here."""

from repro_torch.train.mnist_mlp import evaluate, train_mlp

__all__ = ["train_mlp", "evaluate"]
