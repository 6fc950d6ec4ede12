"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the card's full 700 W power limit): the
denominators of every roofline and utilization share."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def flops(dtype: str) -> float:
    """Peak FLOP/s of products in ``dtype`` (fp32 with TF32 off: the CUDA
    cores' rate)."""
    return FLOPS[dtype]
