"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). A share of a peak is stated against these, with the
card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
