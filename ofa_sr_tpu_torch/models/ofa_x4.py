"""OFAMobileNetX4, the joint learned-downscale + super-resolution supernet.

Counterpart of ofa_sr_tpu/models/ofa_x4.py. Every static conv is 3x3.

- encoder: `pixel_d` blocks of [conv 3->16 (the second 64->16), BN,
  PixelUnshuffle(2)] -> long-skip save -> trunk 0 (n_stages elastic MBConv
  stages) -> three convs 64->64, 64->64 (the skip added after the first),
  64->3: a 3-channel image 2^pixel_d smaller.
- decoder: the S4 topology on trunk 1: conv 3->64 -> skip -> trunk 1 ->
  convs 64->64 x2 (+skip) -> `pixel_d` blocks of [conv 64->256, BN,
  PixelShuffle(2)] -> conv 64->3.

`forward(..., mode="sr")` runs the decoder alone on a bicubic LR input (how
the supernet behind the README's numbers was trained);
`mode="autoencoder"` runs the encoder and the decoder on an HR input. The
same `pixel_d` drives both heads. A subnet has n_trunks = 2 trunks' choices:
trunk t reads ks and e from t * blocks_per_trunk and d from t * n_stages,
so its config comes from the samplers with `n_trunks=2`; a config of
another length raises.

The state_dict has the reference layout, so the JAX package's
`import_torch_x4` reads it unchanged: `blocks.0-1` the unshuffle convs,
then the encoder MBConv blocks, the decoder MBConv blocks and the shuffle
convs in `blocks`; `enc_final_conv_blocks.i`, `dec_first_conv_block`,
`dec_final_conv_blocks.i` and `dec_final_output_conv_block`. `icnr=True`
gives the shuffle convs ICNR init.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.elastic import spatial_valid_mask
from ..utils.device import resolve_device
from .arch import MaskedArch, SearchSpace, SubnetConfig
from .layers import ConvLayer, DynamicMBConvLayer, MobileInvertedResidualBlock
from .ofa_s4 import forward_args, run_trunk, sr_decode


class OFAMobileNetX4(nn.Module):
    CONV_KS = 3
    IN_CH = 3
    n_trunks = 2  # the encoder trunk, then the decoder trunk

    def __init__(self, space: Optional[SearchSpace] = None, *, device="cuda",
                 generator: Optional[torch.Generator] = None, icnr: bool = False):
        """Weights are drawn on the CPU from `generator` (seed 0 if None), in
        the JAX package's init order, then moved to `device`. `icnr`: ICNR
        init of the shuffle convs, else the reference's he_fout."""
        super().__init__()
        sp = self.space = space or SearchSpace()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        w, ks = sp.width, self.CONV_KS
        self.n_mb = sp.blocks_per_trunk
        self.dw_lever = False  # the masked depthwise (layers.set_depthwise_lever)
        self.expand_lever = False  # the masked 1x1 convs (layers.set_expand_lever)
        self.n_shuffle = max(sp.pixel_d_list)

        def trunk():
            return [MobileInvertedResidualBlock(DynamicMBConvLayer(sp, generator=g))
                    for _ in range(self.n_mb)]

        # the unshuffle convs narrow 4x so PixelUnshuffle(2) lands on the
        # trunk width: 3 -> w/4, then w -> w/4
        blocks = [ConvLayer(self.IN_CH if i == 0 else w, w // 4, ks, generator=g)
                  for i in range(self.n_shuffle)]
        blocks += trunk()
        self.enc_final_conv_blocks = nn.ModuleList(
            ConvLayer(w, out_ch, ks, generator=g) for out_ch in (w, w, self.IN_CH))
        self.dec_first_conv_block = ConvLayer(self.IN_CH, w, ks, generator=g)
        blocks += trunk()
        self.dec_final_conv_blocks = nn.ModuleList(
            ConvLayer(w, w, ks, generator=g) for _ in range(2))
        blocks += [ConvLayer(w, 4 * w, ks, generator=g, icnr=icnr)
                   for _ in range(self.n_shuffle)]
        self.blocks = nn.ModuleList(blocks)
        self.dec_final_output_conv_block = ConvLayer(w, self.IN_CH, ks, generator=g)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.dec_first_conv_block.conv.weight.device

    @property
    def unshuffle_blocks(self):
        return list(self.blocks)[:self.n_shuffle]

    @property
    def enc_blocks(self):
        return list(self.blocks)[self.n_shuffle:self.n_shuffle + self.n_mb]

    @property
    def dec_blocks(self):
        return list(self.blocks)[self.n_shuffle + self.n_mb:self.n_shuffle + 2 * self.n_mb]

    @property
    def shuffle_blocks(self):
        return list(self.blocks)[self.n_shuffle + 2 * self.n_mb:]

    def _encode(self, x, cfg, pixel_d, valid_hw, kw):
        smask = None
        for i, layer in enumerate(self.unshuffle_blocks[:pixel_d]):
            x = layer(x, shuffle="unshuffle", **kw)
            if valid_hw is not None:  # resolution halved: the mask at the new shape
                f = 2 ** (i + 1)
                smask = spatial_valid_mask(valid_hw[0] // f, valid_hw[1] // f, x.shape[1],
                                           x.shape[2], x.dtype, x.device)
                x = x * smask
        skip = x
        x = run_trunk(self.enc_blocks, x, cfg, self.space, 0, spatial_mask=smask,
                      dw_lever=self.dw_lever, expand_lever=self.expand_lever, **kw)
        if smask is not None:
            x = x * smask
        for i, layer in enumerate(self.enc_final_conv_blocks):
            x = layer(x, **kw)
            if smask is not None:
                x = x * smask
            if i == 0:
                x = x + skip
        return x

    def encode(self, x, cfg: SubnetConfig, pixel_d: int, *, bn_training: Optional[bool] = None,
               use_kernels: Optional[bool] = None, compute_dtype: Optional[torch.dtype] = None,
               valid_hw=None, bn_group=None):
        """HR image -> the 3-channel learned downscaled image, 2^pixel_d
        smaller. `valid_hw`: the real frame's (h, w) at the HR input; each
        unshuffle halves it."""
        x, kw = forward_args(self, x, cfg, bn_training, use_kernels, compute_dtype, valid_hw,
                             bn_group)
        return self._encode(x, cfg, pixel_d, valid_hw, kw)

    def decode(self, x, cfg: SubnetConfig, pixel_d: int, *, bn_training: Optional[bool] = None,
               use_kernels: Optional[bool] = None, compute_dtype: Optional[torch.dtype] = None,
               valid_hw=None, bn_group=None):
        """3-channel LR image -> the HR reconstruction, 2^pixel_d larger."""
        x, kw = forward_args(self, x, cfg, bn_training, use_kernels, compute_dtype, valid_hw,
                             bn_group)
        return sr_decode(self, x, cfg, pixel_d, trunk=1, valid_hw=valid_hw, **kw)

    def forward(self, x, cfg: SubnetConfig, pixel_d: int, *, mode: str = "sr",
                bn_training: Optional[bool] = None, use_kernels: Optional[bool] = None,
                compute_dtype: Optional[torch.dtype] = None, valid_hw=None, bn_group=None):
        """`mode="sr"`: the decoder on an LR input; `mode="autoencoder"`: the
        encoder, then the decoder, on an HR input. The other arguments are
        OFAMobileNetS4.forward's; in autoencoder mode `valid_hw` is at the
        HR input (its sides multiples of 2^pixel_d) and the decoder takes it
        divided by 2^pixel_d."""
        if mode not in ("sr", "autoencoder"):
            raise ValueError("mode must be 'sr' or 'autoencoder', got %r" % (mode,))
        x, kw = forward_args(self, x, cfg, bn_training, use_kernels, compute_dtype, valid_hw,
                             bn_group)
        if mode == "autoencoder":
            x = self._encode(x, cfg, pixel_d, valid_hw, kw)
            if valid_hw is not None:
                valid_hw = (valid_hw[0] // 2 ** pixel_d, valid_hw[1] // 2 ** pixel_d)
        return sr_decode(self, x, cfg, pixel_d, trunk=1, valid_hw=valid_hw, **kw)

    def forward_masked(self, x, arch, depths, pixel_d: int, **kw):
        """`forward` in the masked form (`OFAMobileNetS4.forward_masked`):
        `arch` the device "ks_idx" and "mid" of both trunks, `depths` the host
        depths of both trunks' stages; `mode` and the rest as `forward`'s."""
        return self(x, MaskedArch(arch["ks_idx"], arch["mid"], tuple(depths), pixel_d),
                    pixel_d, **kw)
