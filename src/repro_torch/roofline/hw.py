"""Target hardware constants: one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
power limit. NVIDIA's datasheet peaks (dense, no sparsity), not
measurements; a card set below 700 W runs slower under load."""

NAME = "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
PEAK_FLOPS_BF16 = 989.4e12  # dense BF16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80 * 10**9  # 80 GB of HBM3
