"""Examples of the PyTorch port, runnable with ``python -m repro_torch.examples.NAME``."""
