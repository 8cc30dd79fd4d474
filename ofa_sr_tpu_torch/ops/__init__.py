from .activations import apply_act, h_sigmoid, h_swish, lrelu, relu, relu6
from .conv import conv2d, conv_init, depthwise_conv2d, depthwise_conv_init, icnr_conv_init
from .elastic import spatial_valid_mask, transform_kernel_chain, transform_matrices_init
from .norm import batch_moments, batch_norm, batch_norm_train
from .pixelshuffle import pixel_shuffle, pixel_unshuffle

__all__ = [
    "apply_act",
    "batch_moments",
    "batch_norm",
    "batch_norm_train",
    "conv2d",
    "conv_init",
    "depthwise_conv2d",
    "depthwise_conv_init",
    "h_sigmoid",
    "h_swish",
    "icnr_conv_init",
    "lrelu",
    "pixel_shuffle",
    "pixel_unshuffle",
    "relu",
    "relu6",
    "spatial_valid_mask",
    "transform_kernel_chain",
    "transform_matrices_init",
]
