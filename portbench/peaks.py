"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).

``FP64_FLOPS`` is the highest float64 rate on the sheet, that of the FP64
tensor cores (the CUDA cores give 34 TFLOP/s): the program's float64
matrix products run on both, so a share of this peak cannot pass 100 %.
"""
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12
