"""Layer modules: the static ConvLayer and the elastic MBConv block.

Counterpart of ofa_sr_tpu/models/layers.py. The JAX package runs every
subnet at max shape with masks so that one jit program serves them all; its
tests prove that equal to slicing. PyTorch runs eagerly, so the port's
forward slices the weight banks the way the reference did
(`_sliced_mbconv_branch` in the JAX package is the statement of it).

Module and parameter names give the reference state_dict layout:
`conv.weight` (OIHW), `bn.{weight,bias,running_mean,running_var}` and, for
the elastic depthwise conv, `conv.7to5_matrix` / `conv.5to3_matrix`.

Every forward takes `bn_training` (train-mode BN: batch moments, running
statistics updated in place; otherwise the running statistics normalize,
which is eval mode and the SR trainer's frozen BN) and `use_kernels` (train
mode through the BN-statistics kernels, `ops/kernels/bn.py`) and
`compute_dtype` (None: the weights' float32; else the mixed-precision type,
bf16, that the conv banks are cast to at use, as the JAX package's
`cast_params_for_compute` casts them: the BN parameters and the
kernel-transform matrices stay float32, and the gradients reach the float32
masters through the casts).
"""

from __future__ import annotations

from torch import nn

from ..ops.activations import relu6
from ..ops.conv import conv2d, conv_init, depthwise_conv2d, depthwise_conv_init, icnr_conv_init
from ..ops.elastic import transform_kernel_chain, transform_matrices_init
from ..ops.norm import batch_norm, batch_norm_train
from ..ops.pixelshuffle import pixel_shuffle
from .arch import SearchSpace


class ConvWeight(nn.Module):
    """A `conv` slot: the OIHW weight and, for an elastic depthwise conv,
    the kernel-transform matrices ('<K>to<k>_matrix')."""

    def __init__(self, weight, matrices=None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.matrix_names = sorted(matrices or {})
        for name in self.matrix_names:
            self.register_parameter(name + "_matrix", nn.Parameter(matrices[name]))

    def matrices(self):
        return {n: getattr(self, n + "_matrix") for n in self.matrix_names}


def cast(w, compute_dtype):
    """A conv bank at use: `w` itself, or a copy in `compute_dtype`."""
    return w if compute_dtype is None else w.to(compute_dtype)


def bn_apply(y, bn: nn.BatchNorm2d, n=None, *, bn_training=False, use_kernels=False):
    """BN with the first `n` channels of `bn` (all if None): train mode
    (updating that prefix of the running statistics) when `bn_training`,
    else normalized with the running statistics. A module's `update_var`
    attribute, where set ("biased" during BN recalibration), picks the
    variance the running statistics take."""
    if bn_training:
        return batch_norm_train(y, bn.weight[:n], bn.bias[:n], bn.running_mean[:n],
                                bn.running_var[:n], momentum=bn.momentum, eps=bn.eps,
                                update_var=getattr(bn, "update_var", "unbiased"),
                                use_kernels=use_kernels)
    return batch_norm(y, bn.weight[:n], bn.bias[:n], bn.running_mean[:n],
                      bn.running_var[:n], eps=bn.eps)


class ConvBN(nn.Module):
    """`conv` + `bn` pair (the reference's conv/bn sub-block)."""

    def __init__(self, weight, *, matrices=None):
        super().__init__()
        self.conv = ConvWeight(weight, matrices)
        self.bn = nn.BatchNorm2d(weight.shape[0])


class ConvLayer(ConvBN):
    """Static conv -> BN -> [PixelShuffle(2)] (the shuffle takes the
    reference's activation slot, after conv + BN; the S4 net has no other
    activation there). `icnr`: ICNR init of a conv feeding the shuffle."""

    def __init__(self, in_ch, out_ch, kernel_size, *, generator, icnr=False):
        init = icnr_conv_init if icnr else conv_init
        super().__init__(init(kernel_size, in_ch, out_ch, generator=generator))

    def forward(self, x, *, shuffle=False, bn_training=False, use_kernels=False,
                compute_dtype=None):
        y = bn_apply(conv2d(x, cast(self.conv.weight, compute_dtype)), self.bn,
                     bn_training=bn_training, use_kernels=use_kernels)
        return pixel_shuffle(y, 2) if shuffle else y


class DynamicMBConvLayer(nn.Module):
    """Elastic MBConv: 1x1 expand -> BN -> relu6 -> k x k depthwise (elastic
    kernel) -> BN -> relu6 -> 1x1 project -> BN. Banks at max shape."""

    def __init__(self, space: SearchSpace, *, generator):
        super().__init__()
        self.ks_list = list(space.ks_list)
        c = space.width
        mid = round(c * space.max_expand)
        self.inverted_bottleneck = ConvBN(conv_init(1, c, mid, generator=generator))
        mats = (transform_matrices_init(space.ks_list)
                if len(space.ks_list) > 1 else None)
        self.depth_conv = ConvBN(
            depthwise_conv_init(space.max_ks, mid, generator=generator),
            matrices=mats)
        self.point_linear = ConvBN(conv_init(1, mid, c, generator=generator))

    def active_depthwise(self, ks, compute_dtype=None):
        """The effective ks x ks depthwise bank [mid_max, 1, ks, ks], in the
        bank's type at use: the bank is cast first, the 7->5->3 chain runs in
        float32 against the float32 matrices, and its result is rounded back
        to the cast bank's type (the JAX package's order)."""
        conv = self.depth_conv.conv
        mats = conv.matrices()
        w = cast(conv.weight, compute_dtype)
        return transform_kernel_chain(w, mats, self.ks_list, ks,
                                      use_transform=bool(mats)).to(w.dtype)

    def forward(self, x, ks, mid, *, bn_training=False, use_kernels=False,
                compute_dtype=None, spatial_mask=None):
        """`spatial_mask`: bucketed eval's (1, H, W, 1) mask, re-zeroing the
        pad before the depthwise conv (the BN bias made it nonzero)."""
        ib, dw, pl = self.inverted_bottleneck, self.depth_conv, self.point_linear
        bn = dict(bn_training=bn_training, use_kernels=use_kernels)
        y = relu6(bn_apply(conv2d(x, cast(ib.conv.weight[:mid], compute_dtype)), ib.bn, mid,
                           **bn))
        if spatial_mask is not None:
            y = y * spatial_mask
        y = depthwise_conv2d(y, self.active_depthwise(ks, compute_dtype)[:mid])
        y = relu6(bn_apply(y, dw.bn, mid, **bn))
        return bn_apply(conv2d(y, cast(pl.conv.weight[:, :mid], compute_dtype)), pl.bn, **bn)


class MobileInvertedResidualBlock(nn.Module):
    """MBConv with the identity shortcut."""

    def __init__(self, mobile_inverted_conv: DynamicMBConvLayer):
        super().__init__()
        self.mobile_inverted_conv = mobile_inverted_conv

    def forward(self, x, ks, mid, **kw):
        return self.mobile_inverted_conv(x, ks, mid, **kw) + x
