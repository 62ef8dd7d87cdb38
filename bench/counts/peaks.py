"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at
the full 700 W power limit): the rates the rooflines and `mfu` divide by."""

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
