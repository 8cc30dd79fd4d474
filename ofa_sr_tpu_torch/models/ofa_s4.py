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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.elastic import spatial_valid_mask
from ..utils.device import resolve_device
from .arch import SearchSpace, SubnetConfig
from .layers import ConvLayer, DynamicMBConvLayer, MobileInvertedResidualBlock


class OFAMobileNetS4(nn.Module):
    CONV_KS = 5
    IN_CH = 3

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
    def shuffle_blocks(self):
        return list(self.blocks)[self.n_mb:]

    def forward(self, x, cfg: SubnetConfig, pixel_d: int, *,
                bn_training: Optional[bool] = None, use_kernels: Optional[bool] = None,
                compute_dtype: Optional[torch.dtype] = None, valid_hw=None):
        """Forward of subnet `cfg` on NHWC `x`; 2^pixel_d upscale.

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
        """
        if bn_training is None:
            bn_training = self.training
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        kw = dict(bn_training=bn_training, use_kernels=use_kernels, compute_dtype=compute_dtype)
        sp = self.space
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        smask = None
        if valid_hw is not None:
            if bn_training:
                raise ValueError("bucketed eval (valid_hw) is eval-mode only: train-mode BN "
                                 "moments would include the pad")
            smask = spatial_valid_mask(valid_hw[0], valid_hw[1], x.shape[1], x.shape[2],
                                       x.dtype, x.device)

        def masked(t):
            return t if smask is None else t * smask

        x = masked(self.dec_first_conv_block(x, **kw))
        skip = x
        for stage in range(sp.n_stages):
            for i in range(cfg.d[stage]):
                bi = stage * sp.max_depth + i
                x = self.blocks[bi](x, cfg.ks[bi], sp.mid_channels(cfg.e[bi]),
                                    spatial_mask=smask, **kw)
        x = masked(x)  # the point-linear BN bias leaked into the pad
        for i, layer in enumerate(self.dec_final_conv_blocks):
            x = masked(layer(x, **kw))
            if i == 0:
                x = x + skip
        for i, layer in enumerate(self.shuffle_blocks[:pixel_d]):
            x = layer(x, shuffle=True, **kw)
            if smask is not None:  # resolution doubled: the mask at the new shape
                f = 2 ** (i + 1)
                smask = spatial_valid_mask(valid_hw[0] * f, valid_hw[1] * f, x.shape[1],
                                           x.shape[2], x.dtype, x.device)
                x = x * smask
        return masked(self.dec_final_output_conv_block(x, **kw))
