"""Layer modules: the static ConvLayer and the elastic MBConv block.

Counterpart of ofa_sr_tpu/models/layers.py. The MBConv has two forms. Its
`forward` slices the weight banks per subnet, the way the reference did
(`_sliced_mbconv_branch` in the JAX package is the statement of it): the
eager path's form. Its `forward_masked` is the JAX package's masked
execution (`_masked_mbconv_apply`): every bank at max shape, the depthwise
conv at the max kernel size through `select_kernel`, and the middle, SE
and output widths channel masks, with the kernel-size index and the widths
read from device tensors, so that one captured CUDA graph serves every
(ks, e, width) of a block; the graphed training steps of the SR and the
classification nets run it (`train/graphs.py`).

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
masters through the casts) and `bn_group` (None, or under data parallelism
the mesh's process group: train-mode BN then takes the moments of every
rank's rows, the JAX package's BN over a sharded batch).

The classification nets' features of the MBConv (JAX `mbconv_init` /
`_masked_mbconv_apply`): input and output widths other than the trunk's,
a per-block activation, a stride in the depthwise conv (padding k//2 per
side, the reference's), the squeeze-excite module under `depth_conv.se`,
and elastic output width: the sliced `forward` takes the point-linear
conv's and its BN's first `out_ch` channels, `forward_masked` masks the
BN from `out_ch` on (`active`), as JAX's `channel_mask` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import apply_act, h_sigmoid
from ..ops.conv import conv2d, conv_init, depthwise_conv2d, depthwise_conv_init, icnr_conv_init
from ..ops.elastic import (
    channel_mask,
    kernel_candidates,
    select_kernel,
    transform_kernel_chain,
    transform_matrices_init,
)
from ..ops.kernels.dw_masked import masked_depthwise, masked_depthwise_reference
from ..ops.kernels.pw_masked import masked_pointwise, masked_pointwise_reference
from ..ops.norm import batch_norm, batch_norm_train
from ..ops.pixelshuffle import pixel_shuffle, pixel_unshuffle
from ..utils.common import make_divisible
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


def linear(x, w, b, compute_dtype=None):
    """x @ w.T + b. In float32 one call; under `compute_dtype` the product
    and the bias add round to that type one after the other, where the JAX
    package's `x @ w + b` rounds them."""
    if compute_dtype is None:
        return F.linear(x, w, b)
    return F.linear(x, cast(w, compute_dtype)) + cast(b, compute_dtype)


def bn_apply(y, bn: nn.BatchNorm2d, n=None, *, bn_training=False, use_kernels=False,
             bn_group=None, active=None):
    """BN with the first `n` channels of `bn` (all if None): train mode
    (updating that prefix of the running statistics) when `bn_training`,
    with the moments of every rank's rows given `bn_group`, else normalized
    with the running statistics. A module's `update_var` attribute, where
    set ("biased" during BN recalibration), picks the variance the running
    statistics take. `active` (the masked form's width, a device int32
    tensor): y is 0 from that channel on, and train mode updates the running
    statistics below it only."""
    if bn_training:
        return batch_norm_train(y, bn.weight[:n], bn.bias[:n], bn.running_mean[:n],
                                bn.running_var[:n], momentum=bn.momentum, eps=bn.eps,
                                update_var=getattr(bn, "update_var", "unbiased"),
                                use_kernels=use_kernels, group=bn_group, active=active)
    return batch_norm(y, bn.weight[:n], bn.bias[:n], bn.running_mean[:n],
                      bn.running_var[:n], eps=bn.eps, active=active)


class ConvBN(nn.Module):
    """`conv` + `bn` pair (the reference's conv/bn sub-block)."""

    def __init__(self, weight, *, matrices=None):
        super().__init__()
        self.conv = ConvWeight(weight, matrices)
        self.bn = nn.BatchNorm2d(weight.shape[0])


class ConvLayer(ConvBN):
    """Static conv -> BN -> [PixelShuffle(2) | PixelUnshuffle(2)] (the
    shuffle takes the reference's activation slot, after conv + BN; the SR
    nets have no other activation there). `icnr`: ICNR init of a conv
    feeding the shuffle."""

    def __init__(self, in_ch, out_ch, kernel_size, *, generator, icnr=False):
        init = icnr_conv_init if icnr else conv_init
        super().__init__(init(kernel_size, in_ch, out_ch, generator=generator))

    def forward(self, x, *, shuffle=None, bn_training=False, use_kernels=False,
                compute_dtype=None, bn_group=None):
        """`shuffle`: None, "shuffle" or "unshuffle" (the JAX package's
        `conv_layer_apply` slot)."""
        y = bn_apply(conv2d(x, cast(self.conv.weight, compute_dtype)), self.bn,
                     bn_training=bn_training, use_kernels=use_kernels, bn_group=bn_group)
        return shuffle_slot(y, shuffle)


def shuffle_slot(y, shuffle):
    """The pixel (un)shuffle slot after conv + BN: None, "shuffle" or
    "unshuffle", by 2."""
    if shuffle is None:
        return y
    if shuffle == "shuffle":
        return pixel_shuffle(y, 2)
    if shuffle == "unshuffle":
        return pixel_unshuffle(y, 2)
    raise ValueError("shuffle must be None, 'shuffle' or 'unshuffle', got %r" % (shuffle,))


class Conv1x1Bias(nn.Module):
    """A 1x1 conv with a bias (the SE module's reduce and expand): OIHW
    `weight` [out, in, 1, 1] and `bias` [out]."""

    def __init__(self, in_ch, out_ch, *, generator):
        super().__init__()
        self.weight = nn.Parameter(conv_init(1, in_ch, out_ch, generator=generator))
        self.bias = nn.Parameter(self.weight.new_zeros(out_ch))


class SEModule(nn.Module):
    """Squeeze-excite at elastic width (the reference's SEModule /
    DynamicSE): global average pool -> 1x1 reduce (+bias) -> ReLU -> 1x1
    expand (+bias) -> h_sigmoid gate on the input. Bottleneck
    make_divisible(mid // 4, 8), both at max width and at the active
    `mid` (JAX's `se_mid`). Under `compute_dtype` both convs' weights and
    biases are cast, as `cast_params_for_compute` casts them."""

    def __init__(self, mid, *, generator):
        super().__init__()
        se_mid = make_divisible(mid // 4, 8)
        self.fc = nn.Module()
        self.fc.reduce = Conv1x1Bias(mid, se_mid, generator=generator)
        self.fc.expand = Conv1x1Bias(se_mid, mid, generator=generator)

    def forward(self, y, compute_dtype=None):
        mid = y.shape[-1]
        se_mid = make_divisible(mid // 4, 8)
        r, e = self.fc.reduce, self.fc.expand
        g = y.mean(dim=(1, 2))
        g = linear(g, r.weight[:se_mid, :mid, 0, 0], r.bias[:se_mid], compute_dtype)
        g = torch.clamp(g, min=0.0)
        g = linear(g, e.weight[:mid, :se_mid, 0, 0], e.bias[:mid], compute_dtype)
        return y * h_sigmoid(g)[:, None, None, :]

    def forward_masked(self, y, mid, se_mid, compute_dtype=None):
        """The masked form (JAX `_masked_mbconv_apply`'s SE): both convs at
        max width, the reduce output masked to `se_mid` before the ReLU,
        and the gated y masked to `mid` (both device int32 widths), the
        sliced form's values."""
        r, e = self.fc.reduce, self.fc.expand
        g = y.mean(dim=(1, 2))
        g = linear(g, r.weight[:, :, 0, 0], r.bias, compute_dtype)
        g = torch.clamp(g * channel_mask(se_mid, g.shape[-1], g.dtype, g.device), min=0.0)
        g = linear(g, e.weight[:, :, 0, 0], e.bias, compute_dtype)
        return (y * h_sigmoid(g)[:, None, None, :]
                * channel_mask(mid, y.shape[-1], y.dtype, y.device))


class DynamicMBConvLayer(nn.Module):
    """Elastic MBConv: 1x1 expand -> BN -> act -> k x k depthwise (elastic
    kernel, stride) -> BN -> act [-> SE] -> 1x1 project -> BN. Banks at max
    shape: `in_ch` -> round(in_ch * max_expand) -> `out_ch` (the trunk's
    width by default), the kernel-transform matrices when
    `use_transform` and the space has more than one kernel size."""

    def __init__(self, space: SearchSpace, *, generator, in_ch=None, out_ch=None,
                 use_se=False, use_transform=True):
        super().__init__()
        self.ks_list = list(space.ks_list)
        c_in = space.width if in_ch is None else in_ch
        c_out = space.width if out_ch is None else out_ch
        mid = round(c_in * space.max_expand)
        self.inverted_bottleneck = ConvBN(conv_init(1, c_in, mid, generator=generator))
        mats = (transform_matrices_init(space.ks_list)
                if use_transform and len(space.ks_list) > 1 else None)
        self.depth_conv = ConvBN(
            depthwise_conv_init(space.max_ks, mid, generator=generator),
            matrices=mats)
        self.point_linear = ConvBN(conv_init(1, mid, c_out, generator=generator))
        self.n_expand = len(space.expand_list)  # the expand lever acts where it is > 1
        if use_se:
            self.depth_conv.se = SEModule(mid, generator=generator)

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

    def forward(self, x, ks, mid, *, act="relu6", stride=1, out_ch=None, bn_training=False,
                use_kernels=False, compute_dtype=None, spatial_mask=None, bn_group=None):
        """x's channels are the active input width; `mid` the active middle
        width, `out_ch` the active output width (None: the bank's).
        `spatial_mask`: bucketed eval's (1, H, W, 1) mask, re-zeroing the
        pad before the depthwise conv (the BN bias made it nonzero)."""
        ib, dw, pl = self.inverted_bottleneck, self.depth_conv, self.point_linear
        bn = dict(bn_training=bn_training, use_kernels=use_kernels, bn_group=bn_group)
        w_ib = ib.conv.weight[:mid, :x.shape[-1]]
        y = apply_act(bn_apply(conv2d(x, cast(w_ib, compute_dtype)), ib.bn, mid, **bn), act)
        if spatial_mask is not None:
            y = y * spatial_mask
        y = depthwise_conv2d(y, self.active_depthwise(ks, compute_dtype)[:mid], stride)
        y = apply_act(bn_apply(y, dw.bn, mid, **bn), act)
        if hasattr(dw, "se"):
            y = dw.se(y, compute_dtype)
        y = conv2d(y, cast(pl.conv.weight[:out_ch, :mid], compute_dtype))
        return bn_apply(y, pl.bn, out_ch, **bn)

    def forward_masked(self, x, ks_idx, mid, *, act="relu6", stride=1, se_mid=None,
                       out_ch=None, bn_training=False, use_kernels=False, compute_dtype=None,
                       spatial_mask=None, bn_group=None, dw_lever=False, expand_lever=False):
        """The masked form of `forward` (the JAX package's
        `_masked_mbconv_apply`): `ks_idx` (an index into the sorted kernel
        sizes), `mid` (the active middle width), `se_mid` (the SE's active
        bottleneck, for a block with SE) and `out_ch` (the active output
        width; None: the bank's) are 0-d int32 device tensors, never read
        by the host. The
        expand conv runs over all max-mid rows, both BNs take the moments at
        full width and mask y beyond `mid` (`active`), the depthwise conv
        runs at the max kernel size with the selected candidate (padding
        max_ks // 2 at any stride: `embed_center` centres the smaller
        kernels, so the sliced conv's taps), the SE masks its reduce output
        to `se_mid` and its gated y to `mid`, the project conv contracts all
        max-mid channels, of which the inactive ones are 0, and its BN masks
        y beyond `out_ch`: the sliced forward's values. A width of 0 gives
        y = 0 and leaves that BN's running statistics unchanged (the
        classification nets' depth gate).

        `dw_lever`: the net's (`set_depthwise_lever`). Set, the depthwise
        runs through `masked_depthwise` over the selected kernel size's
        k x k centre taps and the channels below `mid` alone: the same
        values, since y is 0 from `mid` on. On the card that is
        csrc/dw_masked.cu, unless `use_kernels` is False, which takes its
        plain version.

        `expand_lever`: the net's (`set_expand_lever`, JAX's
        `expand_switch`). Set, on a block without SE whose space has more
        than one expand option (JAX's rule), both 1x1 convs run through
        `masked_pointwise` bounded by `mid`: the expand computes the columns
        below `mid` and writes 0 from it on, the project contracts the first
        `mid` channels alone; the same values, since the masked BN writes 0
        from `mid` on. On the card that is csrc/pw_masked.cu, unless
        `use_kernels` is False, which takes its plain version. JAX asserts
        against it with `out_ch` or `spatial_mask`; this raises ValueError."""
        ib, dw, pl = self.inverted_bottleneck, self.depth_conv, self.point_linear
        if expand_lever and (out_ch is not None or spatial_mask is not None):
            raise ValueError("the expand lever (expand_switch) runs without out_ch and "
                             "spatial_mask, as in the JAX package")
        bn = dict(bn_training=bn_training, use_kernels=use_kernels, bn_group=bn_group,
                  active=mid)
        pw = None
        if expand_lever and not hasattr(dw, "se") and self.n_expand > 1:
            pw = masked_pointwise if use_kernels else masked_pointwise_reference

        def conv1x1(t, w, side):
            return conv2d(t, w) if pw is None else pw(t, w, mid, side=side)

        y = apply_act(bn_apply(conv1x1(x, cast(ib.conv.weight, compute_dtype), "expand"),
                               ib.bn, **bn), act)
        if spatial_mask is not None:
            y = y * spatial_mask
        mats = dw.conv.matrices()
        cands = kernel_candidates(cast(dw.conv.weight, compute_dtype), mats, self.ks_list,
                                  use_transform=bool(mats))
        w_dw = select_kernel(cands, ks_idx)
        if not dw_lever:
            y = depthwise_conv2d(y, w_dw, stride)
        else:
            y = (masked_depthwise if use_kernels else masked_depthwise_reference)(
                y, w_dw, ks_idx, mid, ks_list=self.ks_list, stride=stride)
        y = apply_act(bn_apply(y, dw.bn, **bn), act)
        if hasattr(dw, "se"):
            y = dw.se.forward_masked(y, mid, se_mid, compute_dtype)
        y = conv1x1(y, cast(pl.conv.weight, compute_dtype), "project")
        return bn_apply(y, pl.bn, **dict(bn, active=out_ch))


DW_SWITCHES = (False, True, "dw", "project")
DW_OPTS = ("live", "seam", "align")


def set_depthwise_lever(net, ks_switch=False, dw_switch=False, dw_opts=None):
    """Set the JAX package's depthwise levers on `net`, as its trainers set
    them (ofa_sr_tpu/train/train_step.py:98-119): `ks_switch`, `dw_switch`
    (False, True, "dw" or "project") and `dw_opts` ({"live", "seam",
    "align"}), all off by default, as in JAX. The port has one lever,
    `net.dw_lever`, which the masked forwards read: the depthwise over the
    sampled taps and the first `mid` channels (`masked_depthwise`). Every
    one of JAX's forms gives the same values for the same work or more, so
    each sets it:
    - `ks_switch` (the taps over every channel): the channels from `mid`
      on are 0 in the masked step, so bounding them changes no value.
    - `dw_switch="project"` (`_dwp_switched`: the depthwise BN and the
      project conv in each branch, to shrink the seam where a branch's
      output rejoins the bank width): the kernel has no branches and
      writes the zeros past the bound itself, so there is no seam.
    - `dw_opts["align"]` (the bound rounded up to a multiple of it, to
      share JAX's compiled branches) and `dw_opts["live"]` (a shrink
      phase's lists, `_apply_dw_live`, narrowing them): the kernel takes
      any (ks, mid), so they are checked and change nothing. So is
      `dw_opts["seam"]` (how a branch's output rejoins: none here).
    JAX's `expand_switch` is the other lever (`set_expand_lever`); inside
    its branches JAX forwards `dw_switch` as `ks_switch`, which the
    port's masked depthwise, already bounded by `mid`, covers."""
    if dw_switch not in DW_SWITCHES:
        raise ValueError("dw_switch must be one of %s, got %r" % (DW_SWITCHES, dw_switch))
    unknown = set(dw_opts or {}) - set(DW_OPTS)
    if unknown:
        raise ValueError("dw_opts takes %s; got %s" % (DW_OPTS, sorted(unknown)))
    if ((dw_opts or {}).get("align") or 0) < 0:
        raise ValueError("dw_opts['align'] must be >= 0, got %r" % (dw_opts["align"],))
    net.dw_lever = bool(ks_switch or dw_switch)


def set_expand_lever(net, expand_switch=False):
    """Set the JAX package's `expand_switch` on `net`, as its trainer sets
    it (ofa_sr_tpu/train/train_step.py:91-97), off by default, as in JAX.
    JAX compiles a branch per middle width around each block (`lax.switch`
    over `_sliced_mbconv_branch`), so that the sampled width runs only its
    own work; the port's masked forwards read `net.expand_lever` and run
    both 1x1 convs bounded by the sampled width read on the device
    (`DynamicMBConvLayer.forward_masked`, csrc/pw_masked.cu on the card):
    no branch, so one captured CUDA graph serves every width, and the same
    values. It acts on blocks without SE where the space has more than one
    expand option; the eager step's sliced form runs the sampled width
    already, so the lever changes nothing there."""
    net.expand_lever = bool(expand_switch)


class MobileInvertedResidualBlock(nn.Module):
    """MBConv with the identity shortcut (`shortcut=False`: without, the
    first block of a classification stage)."""

    def __init__(self, mobile_inverted_conv: nn.Module, shortcut: bool = True):
        super().__init__()
        self.mobile_inverted_conv = mobile_inverted_conv
        self.shortcut = shortcut

    def forward(self, x, ks, mid, **kw):
        y = self.mobile_inverted_conv(x, ks, mid, **kw)
        return y + x if self.shortcut else y

    def forward_masked(self, x, ks_idx, mid, **kw):
        y = self.mobile_inverted_conv.forward_masked(x, ks_idx, mid, **kw)
        return y + x if self.shortcut else y
