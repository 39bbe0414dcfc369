"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W limit)."""

PEAK_FLOPS = 989.4e12  # bf16 on the tensor cores, the program's compute type
HBM_BW = 3.35e12  # bytes/s, HBM3
