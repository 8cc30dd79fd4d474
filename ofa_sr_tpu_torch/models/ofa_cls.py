"""Elastic classification supernets, the upstream OFA ImageNet universe
(counterpart of ofa_sr_tpu/models/ofa_cls.py).

OFAMobileNetV3: 3x3 s2 conv 3->16 h_swish -> static e1-k3 MBConv (16->16,
relu, identity shortcut) -> 5 elastic stages (widths 24/40/80/112/160,
strides 2/2/2/1/2, acts relu/relu/h_swish/h_swish/h_swish, SE on stages
2, 4 and 5) of up to 4 elastic MBConv blocks -> 1x1 160->960 (+BN, h_swish)
-> global average pool -> 1x1 960->1280 (no BN, h_swish) -> dropout ->
linear classifier.

OFAProxylessNASNets: 3x3 s2 conv 3->32 relu6 -> e1 block 32->16 -> 6
elastic stages (widths 24/40/80/96/192/320, strides 2/2/2/1/2/1, relu6, no
SE; the last stage one block) -> 1x1 320->1280 (+BN, relu6) -> pool ->
classifier.

`width_mult_list` with more than one entry is runtime elastic width: the
banks live at the widest entry and `arch.wid` picks the active widths.

Two forms of the forward. `forward` slices each layer to the subnet's
widths and runs only the blocks its depths reach, as the reference did:
the eager step's form. `forward_masked` is JAX's `apply`: every block at
max shape, the widths channel masks and the depth a device gate, all read
from the device arch (`arch_vector` / `device_arch`), so one captured CUDA
graph serves every subnet of a batch shape (the graphed training step,
`train/graphs.py`). JAX's tests and the port's prove the two equal.

The state_dict has the reference layout (`first_conv`,
`blocks.0.mobile_inverted_conv.{depth_conv,point_linear}` for the static
first block, `blocks.{1+i}.mobile_inverted_conv...` with
`depth_conv.se.fc.{reduce,expand}`, `final_expand_layer`,
`feature_mix_layer`, `classifier.linear`), which the JAX package's
`import_torch_mbv3` reads unchanged for both families.

Train-mode BN (batch moments, running statistics updated in place) runs
through the BN-forward kernel on a CUDA net (`use_kernels`), at every
channel count, where the JAX package's Pallas BN takes only multiples of
64 (`ofa_sr_tpu/ops/norm.py:76`); the two give the same numbers.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.activations import apply_act
from ..ops.conv import conv2d, conv_init, depthwise_conv2d, depthwise_conv_init
from ..ops.elastic import channel_mask
from ..utils.common import make_divisible
from ..utils.device import resolve_device
from .arch import SearchSpace
from .layers import (
    ConvBN,
    ConvWeight,
    DynamicMBConvLayer,
    MobileInvertedResidualBlock,
    bn_apply,
    cast,
    linear,
)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    width: int
    stride: int
    act: str
    se: bool
    n_block: int


@dataclasses.dataclass(frozen=True)
class ClsArch:
    """A sampled classification subnet: ks and e per elastic block, depth
    per stage, and `wid`, the index into width_mult_list (None: the widest;
    the reference's sampler never draws it)."""
    ks: tuple
    e: tuple
    d: tuple
    wid: Optional[int] = None

    def describe(self):
        s = "ks%s_e%s_d%s" % (list(self.ks), list(self.e), list(self.d))
        if self.wid is not None:
            s += "_w%d" % self.wid
        return s


class FirstBlock(nn.Module):
    """The static e1-k3 first block: depthwise 3x3 (+BN, act) -> 1x1
    (+BN), under the reference's `mobile_inverted_conv` name."""

    def __init__(self, w0, out_ch, *, generator):
        super().__init__()
        self.mobile_inverted_conv = nn.Module()
        self.mobile_inverted_conv.depth_conv = ConvBN(
            depthwise_conv_init(3, w0, generator=generator))
        self.mobile_inverted_conv.point_linear = ConvBN(
            conv_init(1, w0, out_ch, generator=generator))


class ElasticClassifierNet(nn.Module):
    def __init__(self, *, n_classes=1000, stage_specs: Sequence[StageSpec],
                 first_conv_width, first_conv_act, first_block_act, first_block_widths=None,
                 final_expand_width=None, feature_mix_width=1280, head_act="h_swish",
                 ks_list=(3, 5, 7), expand_list=(3, 4, 6), depth_list=(2, 3, 4),
                 dropout_rate=0.1, bn_momentum=0.1, bn_eps=1e-5, use_transform=True,
                 width_mult=1.0, width_mult_list=None, head_width_mode="mbv3",
                 device="cuda", generator: Optional[torch.Generator] = None):
        """Weights are drawn on the CPU from `generator` (seed 0 if None),
        then moved to `device`. `first_block_widths`: the first block's
        output width at each width_mult (None: the first conv's, MBV3)."""
        super().__init__()
        dev = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        wml = sorted(width_mult_list) if width_mult_list else [width_mult]
        self.width_mult_list = wml
        self.dw_lever = False  # the masked depthwise (layers.set_depthwise_lever)
        self.space = SearchSpace(ks_list=list(ks_list), expand_list=list(expand_list),
                                 depth_list=list(depth_list), pixel_d_list=[1],
                                 n_stages=len(stage_specs), width=first_conv_width)
        # per-entity width lists indexed by wid
        self.stage_width_lists = [[make_divisible(sp.width * wm, 8) for wm in wml]
                                  for sp in stage_specs]
        self.stage_specs = [dataclasses.replace(sp, width=max(wl))
                            for sp, wl in zip(stage_specs, self.stage_width_lists)]
        self.first_conv_widths = [make_divisible(first_conv_width * wm, 8) for wm in wml]
        self.first_conv_width = max(self.first_conv_widths)
        self.first_block_outs = list(first_block_widths or self.first_conv_widths)
        self.first_conv_act = first_conv_act
        self.first_block_act = first_block_act
        if head_width_mode == "mbv3":
            # both head widths scaled by the widest entry for every entry:
            # the MBV3 head is not elastic
            self.final_expand_width = (make_divisible(final_expand_width * max(wml), 8)
                                       if final_expand_width else None)
            self.feature_mix_widths = [make_divisible(feature_mix_width * max(wml), 8)] * len(wml)
        else:
            # proxyless last_channel: scaled only where width_mult > 1
            self.final_expand_width = None
            self.feature_mix_widths = [make_divisible(feature_mix_width * wm, 8) if wm > 1.0
                                       else feature_mix_width for wm in wml]
        self.feature_mix_width = max(self.feature_mix_widths)
        self.head_act = head_act
        self.n_classes = n_classes
        self.dropout_rate = dropout_rate
        self.bn_cfg = {"momentum": bn_momentum, "eps": bn_eps}
        self.use_transform = use_transform
        self.n_trunks = 1

        w0 = self.first_conv_width
        self.first_conv = ConvBN(conv_init(3, 3, w0, generator=g))
        blocks = [FirstBlock(w0, self.first_block_out, generator=g)]
        for (in_ch, out_ch, _, _, se, _, i) in self.block_layout():
            layer = DynamicMBConvLayer(self.space, generator=g, in_ch=in_ch, out_ch=out_ch,
                                       use_se=se, use_transform=use_transform)
            blocks.append(MobileInvertedResidualBlock(layer, shortcut=i > 0))
        self.blocks = nn.ModuleList(blocks)
        last_w = self.stage_specs[-1].width
        if self.final_expand_width:
            self.final_expand_layer = ConvBN(
                conv_init(1, last_w, self.final_expand_width, generator=g))
            # feature_mix: 1x1, no BN
            self.feature_mix_layer = nn.Module()
            self.feature_mix_layer.conv = ConvWeight(
                conv_init(1, self.final_expand_width, self.feature_mix_width, generator=g))
        else:
            self.feature_mix_layer = ConvBN(
                conv_init(1, last_w, self.feature_mix_width, generator=g))
        # torch Linear init: U(-1/sqrt(in), 1/sqrt(in)), zero bias
        kin = self.feature_mix_width
        stdv = 1.0 / (kin ** 0.5)
        self.classifier = nn.Module()
        self.classifier.linear = nn.Linear(kin, n_classes)
        with torch.no_grad():
            self.classifier.linear.weight.copy_(
                (torch.rand(n_classes, kin, generator=g) * 2 - 1) * stdv)
            self.classifier.linear.bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum, m.eps = bn_momentum, bn_eps
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.first_conv.conv.weight.device

    @property
    def first_block_out(self):
        return max(self.first_block_outs)

    @property
    def n_blocks(self):
        return sum(sp.n_block for sp in self.stage_specs)

    def active_block_channels(self, wid):
        """(in_ch, out_ch) per elastic block at width index `wid`."""
        ins, outs = [], []
        in_ch = self.first_block_outs[wid]
        for si, sp in enumerate(self.stage_specs):
            w = self.stage_width_lists[si][wid]
            for _ in range(sp.n_block):
                ins.append(in_ch)
                outs.append(w)
                in_ch = w
        return ins, outs

    def block_layout(self):
        """[(in_ch, out_ch, stride, act, se, stage_idx, pos_in_stage)] over
        all elastic blocks at max width, in network order."""
        layout = []
        in_ch = self.first_block_out
        for si, sp in enumerate(self.stage_specs):
            for i in range(sp.n_block):
                layout.append((in_ch, sp.width, sp.stride if i == 0 else 1, sp.act, sp.se, si, i))
                in_ch = sp.width
        return layout

    # -- arch sampling ----------------------------------------------------------

    def sample_arch(self, seed=None, ks_candidates=None, expand_candidates=None,
                    depth_candidates=None, wid_candidates=None) -> ClsArch:
        """The reference's draw order: (wid,) every ks, every e, then each
        stage's d, from Python's `random` (seeded with `seed` if given)."""
        if seed is not None:
            random.seed(seed)
        ks_c = ks_candidates or self.space.ks_list
        e_c = expand_candidates or self.space.expand_list
        d_c = depth_candidates or self.space.depth_list
        wid = random.choice(wid_candidates) if wid_candidates else None
        ks = [random.choice(ks_c) for _ in range(self.n_blocks)]
        e = [random.choice(e_c) for _ in range(self.n_blocks)]
        d = [random.choice(d_c) for _ in range(len(self.stage_specs))]
        return ClsArch(tuple(ks), tuple(e), tuple(d), wid)

    def max_arch(self) -> ClsArch:
        sp = self.space
        return ClsArch(tuple([sp.max_ks] * self.n_blocks),
                       tuple([sp.max_expand] * self.n_blocks),
                       tuple([sp.max_depth] * len(self.stage_specs)))

    def arch_to_device(self, a: ClsArch):
        """The widths a subnet runs at, under the JAX package's keys, as
        Python ints and lists: the host form, which the sliced forward
        reads (JAX's form holds int32 arrays; the port's device form is
        `arch_vector` / `device_arch`)."""
        ks_set = list(self.space.ks_list)
        wid = len(self.width_mult_list) - 1 if a.wid is None else a.wid
        ins, outs = self.active_block_channels(wid)
        mids = [make_divisible(round(in_ch * e), 8) for in_ch, e in zip(ins, a.e)]
        return {
            "ks_idx": [ks_set.index(k) for k in a.ks],
            "mid": mids,
            "se_mid": [make_divisible(m // 4, 8) for m in mids],
            "depth": list(a.d),
            "out_ch": outs,
            "first_w": self.first_conv_widths[wid],
            "fb_out": self.first_block_outs[wid],
            "fm_w": self.feature_mix_widths[wid],
        }

    # the device arch: per block (ks_idx, mid, se_mid, out_ch, gate), per
    # stage the depth, then (first_w, fb_out, fm_w)
    BLOCK_FIELDS = ("ks_idx", "mid", "se_mid", "out_ch", "gate")

    @property
    def arch_len(self):
        """The int32 entries of an `arch_vector`."""
        return len(self.BLOCK_FIELDS) * self.n_blocks + len(self.stage_specs) + 3

    def arch_vector(self, a: ClsArch) -> np.ndarray:
        """The device form of `a` as one int32 vector, JAX `arch_to_device`'s
        values (`device_arch` names its parts): per block ks_idx, mid,
        se_mid, out_ch and the depth gate (1 for a stage's first block and
        for the blocks below its depth, else 0), each stage's depth, then
        first_w, fb_out and fm_w. Copied into one static device buffer, it
        gives a captured graph its next subnet."""
        h = self.arch_to_device(a)
        gate = [int(i == 0 or i < d) for sp, d in zip(self.stage_specs, a.d)
                for i in range(sp.n_block)]
        return np.asarray(h["ks_idx"] + h["mid"] + h["se_mid"] + h["out_ch"] + gate
                          + h["depth"] + [h["first_w"], h["fb_out"], h["fm_w"]], np.int32)

    def device_arch(self, buf):
        """{JAX `arch_to_device`'s keys and "gate"}: views of an
        `arch_vector` in the int32 tensor `buf` (no copy), the widths 0-d."""
        nb, ns = self.n_blocks, len(self.stage_specs)
        parts = buf.split([nb] * len(self.BLOCK_FIELDS) + [ns, 1, 1, 1])
        out = dict(zip(self.BLOCK_FIELDS + ("depth",), parts))
        out.update(first_w=parts[-3][0], fb_out=parts[-2][0], fm_w=parts[-1][0])
        return out

    def arch_tensor(self, a: ClsArch, device=None):
        """`device_arch` of a new device buffer holding `a`."""
        return self.device_arch(torch.from_numpy(self.arch_vector(a)).to(device or self.device))

    # -- forward ----------------------------------------------------------------

    def forward(self, x, arch: ClsArch, *, training=False, bn_training=None, use_kernels=None,
                dropout_generator: Optional[torch.Generator] = None,
                compute_dtype: Optional[torch.dtype] = None, bn_group=None):
        """Logits of subnet `arch` on NHWC images `x`. BN runs in train mode
        (batch moments, the active channels' running statistics updated in
        place) when `bn_training`, which defaults to `training`;
        `use_kernels` (default: on for a CUDA net) takes train-mode BN
        through the BN-forward kernel. Dropout before the classifier runs
        only in training with a `dropout_generator`, as JAX's runs only with
        a `dropout_rng`.

        `compute_dtype` (bf16) is the JAX package's mixed precision
        (`cast_params_for_compute`): the input and every weight but the BN
        parameters and the kernel-transform matrices (the convs, the SE
        convs' weights and biases, the classifier's weight and bias) are
        cast at use, and the logits come back float32. `bn_group`: under
        data parallelism, the mesh's process group, over whose rows every
        train-mode BN takes its moments."""
        bnt = bool(training if bn_training is None else bn_training)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        cd = compute_dtype
        if cd is not None:
            x = x.to(cd)
        a = self.arch_to_device(arch)
        bn = dict(bn_training=bnt, use_kernels=use_kernels, bn_group=bn_group)
        fw, fbo = a["first_w"], a["fb_out"]

        fc = self.first_conv
        y = apply_act(bn_apply(conv2d(x, cast(fc.conv.weight[:fw], cd), stride=2), fc.bn, fw,
                               **bn), self.first_conv_act)
        fb = self.blocks[0].mobile_inverted_conv
        h = depthwise_conv2d(y, cast(fb.depth_conv.conv.weight[:fw], cd))
        h = apply_act(bn_apply(h, fb.depth_conv.bn, fw, **bn), self.first_block_act)
        h = bn_apply(conv2d(h, cast(fb.point_linear.conv.weight[:fbo, :fw], cd)),
                     fb.point_linear.bn, fbo, **bn)
        # identity shortcut where the block keeps the width (MBV3)
        y = y + h if self.first_block_out == self.first_conv_width else h

        ks_set = self.space.ks_list
        bi = 0
        for si, spec in enumerate(self.stage_specs):
            for i in range(spec.n_block):
                # the first block of a stage always runs; the rest up to d
                if i == 0 or i < a["depth"][si]:
                    y = self.blocks[1 + bi](y, ks_set[a["ks_idx"][bi]], a["mid"][bi],
                                            act=spec.act, stride=spec.stride if i == 0 else 1,
                                            out_ch=a["out_ch"][bi], compute_dtype=cd, **bn)
                bi += 1

        if self.final_expand_width:
            fe = self.final_expand_layer
            y = conv2d(y, cast(fe.conv.weight[:, :y.shape[-1]], cd))
            y = apply_act(bn_apply(y, fe.bn, **bn), self.head_act)
            y = y.mean(dim=(1, 2), keepdim=True)
            y = apply_act(conv2d(y, cast(self.feature_mix_layer.conv.weight, cd)), self.head_act)
            y = y[:, 0, 0, :]
        else:
            fm, fm_w = self.feature_mix_layer, a["fm_w"]
            y = conv2d(y, cast(fm.conv.weight[:fm_w, :y.shape[-1]], cd))
            y = apply_act(bn_apply(y, fm.bn, fm_w, **bn), self.head_act)
            y = y.mean(dim=(1, 2))

        return self._classify(y, training, dropout_generator, cd)

    def _classify(self, y, training, dropout_generator, cd):
        """Dropout (in training, with a generator) and the classifier on the
        pooled features y; float32 logits."""
        if training and self.dropout_rate > 0 and dropout_generator is not None:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(y.shape, generator=dropout_generator,
                              device=dropout_generator.device) < keep
            y = torch.where(mask.to(y.device), y / keep, torch.zeros_like(y))
        lin = self.classifier.linear
        logits = linear(y, lin.weight[:, :y.shape[-1]], lin.bias, cd)
        return logits if cd is None else logits.float()

    def forward_masked(self, x, arch, *, training=False, bn_training=None, use_kernels=None,
                       dropout_generator: Optional[torch.Generator] = None,
                       compute_dtype: Optional[torch.dtype] = None, bn_group=None):
        """`forward` in the masked form (JAX `apply`): `arch` is the device
        arch (`device_arch`), read on the device only. Every layer runs at
        its max shape: the elastic widths are channel masks (the BNs'
        `active`; Proxyless multiplies the head's output by its width's
        mask), which JAX applies only where a width list has more than one
        entry, and so does this. Every block runs; a block after a stage's
        first is gated, y = where(gate, block(y), y), and its BNs take
        mid * gate and out_ch * gate as their widths, so a gated-off block
        writes 0 and keeps its running statistics (JAX's where over its
        state). Dropout draws the shape of the max-width features, which is
        the sliced forward's where the widths are not elastic. The other
        arguments are `forward`'s: under `bn_group` every train-mode BN
        takes the moments of all the ranks' rows with its width. The
        elastic blocks' depthwise takes the net's lever `dw_lever`
        (`layers.set_depthwise_lever`): a gated-off block's bound is its
        width, 0."""
        bnt = bool(training if bn_training is None else bn_training)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        cd = compute_dtype
        if cd is not None:
            x = x.to(cd)
        bn = dict(bn_training=bnt, use_kernels=use_kernels, bn_group=bn_group)

        def elastic(widths, key):
            return arch[key] if len(set(widths)) > 1 else None

        fw = elastic(self.first_conv_widths, "first_w")
        fbo = elastic(self.first_block_outs, "fb_out")
        fc = self.first_conv
        y = apply_act(bn_apply(conv2d(x, cast(fc.conv.weight, cd), stride=2), fc.bn, active=fw,
                               **bn), self.first_conv_act)
        fb = self.blocks[0].mobile_inverted_conv
        h = depthwise_conv2d(y, cast(fb.depth_conv.conv.weight, cd))
        h = apply_act(bn_apply(h, fb.depth_conv.bn, active=fw, **bn), self.first_block_act)
        h = bn_apply(conv2d(h, cast(fb.point_linear.conv.weight, cd)), fb.point_linear.bn,
                     active=fbo, **bn)
        y = y + h if self.first_block_out == self.first_conv_width else h

        gate = arch["gate"].bool()
        mid_g, out_g = arch["mid"] * arch["gate"], arch["out_ch"] * arch["gate"]
        bi = 0
        for si, spec in enumerate(self.stage_specs):
            out_elastic = len(set(self.stage_width_lists[si])) > 1
            for i in range(spec.n_block):
                kw = dict(act=spec.act, stride=spec.stride if i == 0 else 1,
                          se_mid=arch["se_mid"][bi], compute_dtype=cd, dw_lever=self.dw_lever,
                          **bn)
                block = self.blocks[1 + bi]
                if i == 0:  # always runs; no shortcut
                    y = block.forward_masked(y, arch["ks_idx"][bi], arch["mid"][bi],
                                             out_ch=arch["out_ch"][bi] if out_elastic else None,
                                             **kw)
                else:
                    y = torch.where(gate[bi], block.forward_masked(
                        y, arch["ks_idx"][bi], mid_g[bi], out_ch=out_g[bi], **kw), y)
                bi += 1

        if self.final_expand_width:
            fe = self.final_expand_layer
            y = apply_act(bn_apply(conv2d(y, cast(fe.conv.weight, cd)), fe.bn, **bn),
                          self.head_act)
            y = y.mean(dim=(1, 2), keepdim=True)
            y = apply_act(conv2d(y, cast(self.feature_mix_layer.conv.weight, cd)), self.head_act)
            y = y[:, 0, 0, :]
        else:
            fm, fm_w = self.feature_mix_layer, elastic(self.feature_mix_widths, "fm_w")
            y = apply_act(bn_apply(conv2d(y, cast(fm.conv.weight, cd)), fm.bn, active=fm_w, **bn),
                          self.head_act)
            if fm_w is not None:  # the classifier's input: the sliced weight's
                y = y * channel_mask(fm_w, y.shape[-1], y.dtype, y.device)
            y = y.mean(dim=(1, 2))
        return self._classify(y, training, dropout_generator, cd)


def OFAMobileNetV3(n_classes=1000, ks_list=(3, 5, 7), expand_list=(3, 4, 6),
                   depth_list=(2, 3, 4), width_mult=1.0, dropout_rate=0.1, bn_momentum=0.1,
                   bn_eps=1e-5, use_transform=True, width_mult_list=None, *, device="cuda",
                   generator=None):
    md = max(depth_list)
    return ElasticClassifierNet(
        n_classes=n_classes,
        stage_specs=[
            StageSpec(24, 2, "relu", False, md),
            StageSpec(40, 2, "relu", True, md),
            StageSpec(80, 2, "h_swish", False, md),
            StageSpec(112, 1, "h_swish", True, md),
            StageSpec(160, 2, "h_swish", True, md),
        ],
        first_conv_width=16, first_conv_act="h_swish", first_block_act="relu",
        final_expand_width=960, feature_mix_width=1280, head_act="h_swish",
        ks_list=ks_list, expand_list=expand_list, depth_list=depth_list,
        dropout_rate=dropout_rate, bn_momentum=bn_momentum, bn_eps=bn_eps,
        use_transform=use_transform, width_mult=width_mult,
        width_mult_list=width_mult_list, head_width_mode="mbv3", device=device,
        generator=generator)


def OFAProxylessNASNets(n_classes=1000, ks_list=(3, 5, 7), expand_list=(3, 4, 6),
                        depth_list=(2, 3, 4), width_mult=1.0, dropout_rate=0.1,
                        bn_momentum=0.1, bn_eps=1e-3, use_transform=True, width_mult_list=None,
                        *, device="cuda", generator=None):
    md = max(depth_list)
    wml = sorted(width_mult_list) if width_mult_list else [width_mult]
    return ElasticClassifierNet(
        n_classes=n_classes,
        stage_specs=[
            StageSpec(24, 2, "relu6", False, md),
            StageSpec(40, 2, "relu6", False, md),
            StageSpec(80, 2, "relu6", False, md),
            StageSpec(96, 1, "relu6", False, md),
            StageSpec(192, 2, "relu6", False, md),
            StageSpec(320, 1, "relu6", False, 1),
        ],
        first_conv_width=32, first_conv_act="relu6", first_block_act="relu6",
        # the first block narrows 32 -> 16
        first_block_widths=[make_divisible(16 * wm, 8) for wm in wml],
        final_expand_width=None, feature_mix_width=1280, head_act="relu6",
        ks_list=ks_list, expand_list=expand_list, depth_list=depth_list,
        dropout_rate=dropout_rate, bn_momentum=bn_momentum, bn_eps=bn_eps,
        use_transform=use_transform, width_mult=width_mult,
        width_mult_list=width_mult_list, head_width_mode="proxyless", device=device,
        generator=generator)
