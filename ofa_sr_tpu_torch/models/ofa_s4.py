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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .arch import SearchSpace, SubnetConfig
from .layers import ConvLayer, DynamicMBConvLayer, MobileInvertedResidualBlock


class OFAMobileNetS4(nn.Module):
    CONV_KS = 5
    IN_CH = 3

    def __init__(self, space: Optional[SearchSpace] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """Weights are drawn on the CPU from `generator` (seed 0 if None),
        then moved to `device`, so a seed gives the same weights on every
        device."""
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
        blocks += [ConvLayer(sp.width, 4 * sp.width, self.CONV_KS, generator=g)
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
                bn_training: Optional[bool] = None, use_kernels: Optional[bool] = None):
        """Forward of subnet `cfg` on NHWC `x`; 2^pixel_d upscale.

        BN runs in train mode (batch moments, running statistics updated in
        place) when `bn_training`, which defaults to `self.training`;
        `bn_training=False` on a training net is the SR trainer's frozen BN.
        `use_kernels` (default: on for a CUDA net) takes train-mode BN
        through the BN-statistics kernels. Only the first `cfg.d[stage]`
        blocks of a stage and the first `pixel_d` shuffle blocks execute, so
        the others get no gradient (`grad is None`).
        """
        if bn_training is None:
            bn_training = self.training
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        bn = dict(bn_training=bn_training, use_kernels=use_kernels)
        sp = self.space
        x = self.dec_first_conv_block(x, **bn)
        skip = x
        for stage in range(sp.n_stages):
            for i in range(cfg.d[stage]):
                bi = stage * sp.max_depth + i
                x = self.blocks[bi](x, cfg.ks[bi], sp.mid_channels(cfg.e[bi]), **bn)
        for i, layer in enumerate(self.dec_final_conv_blocks):
            x = layer(x, **bn)
            if i == 0:
                x = x + skip
        for layer in self.shuffle_blocks[:pixel_d]:
            x = layer(x, shuffle=True, **bn)
        return self.dec_final_output_conv_block(x, **bn)
