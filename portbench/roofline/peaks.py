"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU datasheet, https://www.nvidia.com/en-us/data-center/h100/ ; dense
rates, at the card's full 700 W power limit).

The port's f64 kernels run on the CUDA cores, not the tensor cores, so
34 TFLOP/s is what they could reach; a roofline share is taken against
67 TFLOP/s, the least time the chip could take for f64 work at all."""

FP64_TENSOR_FLOPS = 67e12   # FP64 Tensor Core
FP64_FLOPS = 34e12          # FP64 on the CUDA cores
FP32_FLOPS = 67e12          # FP32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth

# the peak a roofline or an mfu is taken against, by the conf's [dtype]
ROOF_FLOPS = {"f64": FP64_TENSOR_FLOPS, "f32": FP32_FLOPS}


def bound_s(flops: float, nbytes: float, dtype: str = "f64") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / ROOF_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
