"""Hand-written CUDA kernels (counterparts of ofa_sr_tpu/ops/pallas/, and
the masked depthwise and 1x1 convs of the JAX package's depthwise and
expand levers, XLA ops there), each beside its plain PyTorch version.
Importing this package needs neither a GPU nor nvcc: a kernel is built at
its first launch."""

from .bn import bn_train_fused
from .bn_stats import (
    bn_backward,
    bn_backward_reference,
    bn_bwd_sums,
    bn_bwd_sums_reference,
    bn_forward,
    bn_forward_reference,
    bn_moments,
    bn_moments_reference,
    col_sums2,
    col_sums2_reference,
)
from .dw_masked import masked_depthwise, masked_depthwise_reference
from .mbconv import fused_mbconv_infer, mbconv_reference
from .pw_masked import masked_pointwise, masked_pointwise_reference
from .shuffle_tail import fused_shuffle_tail, shuffle_tail_reference

__all__ = [
    "bn_backward",
    "bn_backward_reference",
    "bn_bwd_sums",
    "bn_bwd_sums_reference",
    "bn_forward",
    "bn_forward_reference",
    "bn_moments",
    "bn_moments_reference",
    "bn_train_fused",
    "col_sums2",
    "col_sums2_reference",
    "fused_mbconv_infer",
    "fused_shuffle_tail",
    "masked_depthwise",
    "masked_depthwise_reference",
    "masked_pointwise",
    "masked_pointwise_reference",
    "mbconv_reference",
    "shuffle_tail_reference",
]
