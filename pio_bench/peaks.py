"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). A card set below 700 W reaches less; every
share the benchmark reports is of these numbers, and PERF.md gives the
card's power limit beside it."""

#: HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12
#: f32 on the CUDA cores, outside the tensor cores
F32_OPS_PER_S = 67e12
#: TF32 on the tensor cores
TF32_MMA_OPS_PER_S = 495e12
#: f32 products as 3xTF32 (three TF32 mma each) reach a third of the TF32
#: rate: the fastest f32-exact rate the card has, and the peak of every
#: share here. The configurations compute in f32 with TF32 off; a share
#: of the 67 TFLOP/s CUDA-core rate would pass 100% once a kernel moved
#: onto the tensor cores.
F32_EXACT_OPS_PER_S = TF32_MMA_OPS_PER_S / 3
