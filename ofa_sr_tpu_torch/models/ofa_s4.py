"""OFAMobileNetS4, the decoder-only 2x/4x super-resolution supernet.

Counterpart of ofa_sr_tpu/models/ofa_s4.py. Topology: 5x5 conv 3->64 ->
long-skip save -> n_stages elastic stages of up to max_depth MBConv blocks
(64->64, relu6, identity shortcut) -> two 5x5 convs 64->64 with the long skip
added after the first -> `pixel_d` blocks of [5x5 conv 64->256, BN,
PixelShuffle(2)] -> 5x5 conv 64->3 (+BN).

The state_dict has the reference layout, so the JAX package's
`import_torch_s4` reads it unchanged:
`dec_first_conv_block`, `blocks.N.mobile_inverted_conv.*` for the MBConv
blocks, `dec_final_conv_blocks.i`, the shuffle convs as `blocks.{n_mb+i}`,
and `dec_final_output_conv_block`.

`icnr=True` gives the shuffle convs ICNR init (the JAX package's option);
`forward(..., compute_dtype=torch.bfloat16)` is the mixed-precision forward
of the JAX trainer's `compute_dtype`, and `forward(..., valid_hw=(h, w))` the
shape-bucketed eval of a frame zero-padded into a larger input.

`forward` takes a SubnetConfig (the sliced form) or a `MaskedArch` (the
masked form, whose kernel sizes and widths are device tensors);
`forward_masked(x, arch, depths, pixel_d)` is the masked form's entry: the
JAX package's `net.apply(..., arch=cfg.to_device(space))`, with the depths
and pixel_d on the host. The masked form reads the net's depthwise lever
`dw_lever`, which the trainers set from JAX's `ks_switch`, `dw_switch` and
`dw_opts` (`layers.set_depthwise_lever`), and its expand lever
`expand_lever`, which the SR trainer sets from JAX's `expand_switch`
(`layers.set_expand_lever`); the sliced form has no use for either, since
it runs only the sampled taps and channels already.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.elastic import spatial_valid_mask
from ..utils.device import resolve_device
from .arch import MaskedArch, SearchSpace, SubnetConfig, check_n_trunks
from .layers import ConvLayer, DynamicMBConvLayer, MobileInvertedResidualBlock


class OFAMobileNetS4(nn.Module):
    CONV_KS = 5
    IN_CH = 3
    n_trunks = 1

    def __init__(self, space: Optional[SearchSpace] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None, icnr: bool = False):
        """Weights are drawn on the CPU from `generator` (seed 0 if None),
        then moved to `device`, so a seed gives the same weights on every
        device. `icnr`: ICNR init of the shuffle convs (checkerboard-free at
        init), else the reference's he_fout."""
        super().__init__()
        sp = self.space = space or SearchSpace()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.n_mb = sp.blocks_per_trunk
        self.n_shuffle = max(sp.pixel_d_list)
        self.dw_lever = False  # the masked depthwise (layers.set_depthwise_lever)
        self.expand_lever = False  # the masked 1x1 convs (layers.set_expand_lever)

        self.dec_first_conv_block = ConvLayer(
            self.IN_CH, sp.width, self.CONV_KS, generator=g)
        blocks = [MobileInvertedResidualBlock(DynamicMBConvLayer(sp, generator=g))
                  for _ in range(self.n_mb)]
        self.dec_final_conv_blocks = nn.ModuleList(
            ConvLayer(sp.width, sp.width, self.CONV_KS, generator=g)
            for _ in range(2))
        blocks += [ConvLayer(sp.width, 4 * sp.width, self.CONV_KS, generator=g, icnr=icnr)
                   for _ in range(self.n_shuffle)]
        self.blocks = nn.ModuleList(blocks)
        self.dec_final_output_conv_block = ConvLayer(
            sp.width, self.IN_CH, self.CONV_KS, generator=g)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.dec_first_conv_block.conv.weight.device

    @property
    def dec_blocks(self):
        return list(self.blocks)[:self.n_mb]

    @property
    def shuffle_blocks(self):
        return list(self.blocks)[self.n_mb:]

    def forward(self, x, cfg: SubnetConfig, pixel_d: int, *, mode: str = "sr",
                bn_training: Optional[bool] = None, use_kernels: Optional[bool] = None,
                compute_dtype: Optional[torch.dtype] = None, valid_hw=None, bn_group=None):
        """Forward of subnet `cfg` on NHWC `x`; 2^pixel_d upscale. `mode`
        is "sr", the only one of this decoder-only net (the X4 net's
        interface).

        BN runs in train mode (batch moments, running statistics updated in
        place) when `bn_training`, which defaults to `self.training`;
        `bn_training=False` on a training net is the SR trainer's frozen BN.
        `use_kernels` (default: on for a CUDA net) takes train-mode BN
        through the BN-statistics kernels. Only the first `cfg.d[stage]`
        blocks of a stage and the first `pixel_d` shuffle blocks execute, so
        the others get no gradient (`grad is None`).

        `compute_dtype` (e.g. torch.bfloat16): x and every conv bank are cast
        to it at use, the BN parameters and transform matrices stay float32
        (so do BN's statistics and normalize), and the output comes back in
        it; the gradients reach the float32 parameters through the casts.

        `valid_hw`: (h, w) of the real frame inside a zero-padded bucket
        input; the pad is re-zeroed before every spatial conv, so the valid
        region equals the unpadded frame's output. Eval-mode BN only (batch
        moments would include the pad): raises under train-mode BN.

        `bn_group` (data parallelism: the mesh's process group, x this
        rank's rows of the global batch): every train-mode BN takes the
        moments of all the ranks' rows (an all-reduce each way a BN).
        """
        if mode != "sr":
            raise ValueError("OFAMobileNetS4 has the decoder only: mode=%r needs an "
                             "OFAMobileNetX4" % (mode,))
        x, kw = forward_args(self, x, cfg, bn_training, use_kernels, compute_dtype, valid_hw,
                             bn_group)
        return sr_decode(self, x, cfg, pixel_d, trunk=0, valid_hw=valid_hw, **kw)

    def forward_masked(self, x, arch, depths, pixel_d: int, **kw):
        """`forward` in the masked form: `arch` holds the device tensors
        "ks_idx" and "mid" (`SubnetConfig.to_device`), `depths` the host
        depths a stage (only the first d blocks of a stage run, the JAX
        package's switch over depth options), `pixel_d` the host pixel depth.
        The other arguments are `forward`'s."""
        return self(x, MaskedArch(arch["ks_idx"], arch["mid"], tuple(depths), pixel_d),
                    pixel_d, **kw)


def forward_args(net, x, cfg, bn_training, use_kernels, compute_dtype, valid_hw,
                 bn_group=None):
    """A supernet forward's checks and defaults: `cfg` sampled for the net's
    trunk count; train-mode BN by default on a training net; the kernels by
    default on a CUDA net; x cast to `compute_dtype`; no `valid_hw` under
    train-mode BN. Returns (x, the layers' keyword arguments)."""
    check_n_trunks(net.space, cfg, net.n_trunks)
    if bn_training is None:
        bn_training = net.training
    if use_kernels is None:
        use_kernels = net.device.type == "cuda"
    if valid_hw is not None and bn_training:
        raise ValueError("bucketed eval (valid_hw) is eval-mode only: train-mode BN "
                         "moments would include the pad")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return x, dict(bn_training=bn_training, use_kernels=use_kernels, compute_dtype=compute_dtype,
                   bn_group=bn_group)


def run_trunk(blocks, x, cfg, space, trunk, *, spatial_mask=None, dw_lever=False,
              expand_lever=False, **kw):
    """The elastic stages of trunk `trunk` (its MBConv `blocks`): the first
    `d` blocks of each stage run, with ks and e read from the trunk's slice
    of `cfg` (block entries from trunk * blocks_per_trunk, depths from
    trunk * n_stages, as the JAX package's `_trunk`): sliced for a
    SubnetConfig, masked for a MaskedArch (its device ks_idx and mid), with
    the net's depthwise lever `dw_lever` (`set_depthwise_lever`) and expand
    lever `expand_lever` (`set_expand_lever`; the sliced blocks run only
    the sampled taps and channels already)."""
    base_b, base_s = trunk * space.blocks_per_trunk, trunk * space.n_stages
    masked = isinstance(cfg, MaskedArch)
    for stage in range(space.n_stages):
        for i in range(cfg.d[base_s + stage]):
            bi = stage * space.max_depth + i
            if masked:
                x = blocks[bi].forward_masked(x, cfg.ks_idx[base_b + bi], cfg.mid[base_b + bi],
                                              spatial_mask=spatial_mask, dw_lever=dw_lever,
                                              expand_lever=expand_lever, **kw)
            else:
                x = blocks[bi](x, cfg.ks[base_b + bi], space.mid_channels(cfg.e[base_b + bi]),
                               spatial_mask=spatial_mask, **kw)
    return x


def sr_decode(net, x, cfg, pixel_d, *, trunk, valid_hw=None, **kw):
    """The SR decoder of `net` (an S4 net, or an X4 net's decoder, whose
    modules have the same names) on `x` prepared by `forward_args`: first
    conv, the trunk `trunk`, the two final convs with the long skip, the
    first `pixel_d` shuffle blocks and the output conv. `valid_hw`: the
    real frame's (h, w) in `x`, the pad re-zeroed before every spatial
    conv."""
    smask = None
    if valid_hw is not None:
        smask = spatial_valid_mask(valid_hw[0], valid_hw[1], x.shape[1], x.shape[2],
                                   x.dtype, x.device)

    def masked(t):
        return t if smask is None else t * smask

    x = masked(net.dec_first_conv_block(x, **kw))
    skip = x
    x = run_trunk(net.dec_blocks, x, cfg, net.space, trunk, spatial_mask=smask,
                  dw_lever=net.dw_lever, expand_lever=net.expand_lever, **kw)
    x = masked(x)  # the point-linear BN bias leaked into the pad
    for i, layer in enumerate(net.dec_final_conv_blocks):
        x = masked(layer(x, **kw))
        if i == 0:
            x = x + skip
    for i, layer in enumerate(net.shuffle_blocks[:pixel_d]):
        x = layer(x, shuffle="shuffle", **kw)
        if smask is not None:  # resolution doubled: the mask at the new shape
            f = 2 ** (i + 1)
            smask = spatial_valid_mask(valid_hw[0] * f, valid_hw[1] * f, x.shape[1],
                                       x.shape[2], x.dtype, x.device)
            x = x * smask
    return masked(net.dec_final_output_conv_block(x, **kw))
