"""Hand-written CUDA kernels (counterparts of ofa_sr_tpu/ops/pallas/), each
beside its plain PyTorch version. Importing this package needs neither a GPU
nor nvcc: a kernel is built at its first launch."""

from .mbconv import fused_mbconv_infer, mbconv_reference
from .shuffle_tail import fused_shuffle_tail, shuffle_tail_reference

__all__ = [
    "fused_mbconv_infer",
    "fused_shuffle_tail",
    "mbconv_reference",
    "shuffle_tail_reference",
]
