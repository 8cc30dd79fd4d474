"""Subnet-config serialization (counterpart of
ofa_sr_tpu/models/net_config.py): the layer registry, static nets built from
the reference's `net.config` dicts, config extraction from an elastic
classification supernet, and weight transfer into the static net.

The JSON schema is the reference's own net.config format, so a config
written by either package builds in both. A layer is an `nn.Module` built
from its config dict and registered by the config's name; a static net is
their composition, with the reference's state_dict layout, so a reference
specialized-net state_dict (or the JAX package's, through the weight
bridge) loads into it directly.

For the SR nets subnets serialize as `SubnetConfig` dicts instead (the
reference's net.config plumbing for them is broken).
"""

from __future__ import annotations

import json
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import apply_act
from ..ops.conv import conv2d, conv_init, depthwise_conv2d, depthwise_conv_init
from ..utils.device import resolve_device
from .layers import ConvBN, ConvWeight, SEModule, bn_apply


def _check(cfg, **expected):
    for k, v in expected.items():
        got = cfg.get(k, v)
        if got != v:
            raise NotImplementedError("%s=%r unsupported (only %r)" % (k, got, v))


class ConvLayer(nn.Module):
    """The reference ConvLayer: conv (+bias) -> BN -> act."""

    def __init__(self, cfg, *, generator):
        super().__init__()
        _check(cfg, dilation=1, groups=1, has_shuffle=False, ops_order="weight_bn_act")
        self.cfg = cfg
        out = cfg["out_channels"]
        self.conv = ConvWeight(conv_init(cfg["kernel_size"], cfg["in_channels"], out,
                                         generator=generator))
        if cfg.get("bias", False):
            self.conv.bias = nn.Parameter(torch.zeros(out))
        if cfg.get("use_bn", True):
            self.bn = nn.BatchNorm2d(out)

    def forward(self, x, **bn):
        y = conv2d(x, self.conv.weight, stride=self.cfg.get("stride", 1))
        if hasattr(self.conv, "bias"):
            y = y + self.conv.bias
        if hasattr(self, "bn"):
            y = bn_apply(y, self.bn, **bn)
        return apply_act(y, self.cfg.get("act_func"))


class DepthConvLayer(nn.Module):
    """The reference DepthConvLayer: depthwise conv -> 1x1 point conv ->
    BN -> act."""

    def __init__(self, cfg, *, generator):
        super().__init__()
        _check(cfg, dilation=1, has_shuffle=False, ops_order="weight_bn_act")
        self.cfg = cfg
        cin, out = cfg["in_channels"], cfg["out_channels"]
        self.depth_conv = ConvWeight(depthwise_conv_init(cfg["kernel_size"], cin,
                                                         generator=generator))
        self.point_conv = ConvWeight(conv_init(1, cin, out, generator=generator))
        if cfg.get("use_bn", True):
            self.bn = nn.BatchNorm2d(out)

    def forward(self, x, **bn):
        y = depthwise_conv2d(x, self.depth_conv.weight, self.cfg.get("stride", 1))
        y = conv2d(y, self.point_conv.weight)
        if hasattr(self, "bn"):
            y = bn_apply(y, self.bn, **bn)
        return apply_act(y, self.cfg.get("act_func"))


class PoolingLayer(nn.Module):
    """The reference PoolingLayer, avg or max, padding k//2 per side (the
    average counts the zero padding, as JAX's reduce_window sum / k^2)."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        if cfg["pool_type"] not in ("avg", "max"):
            raise NotImplementedError(cfg["pool_type"])
        self.cfg = cfg

    def forward(self, x, **bn):
        k, st = self.cfg.get("kernel_size", 2), self.cfg.get("stride", 2)
        pool = F.avg_pool2d if self.cfg["pool_type"] == "avg" else F.max_pool2d
        y = pool(x.permute(0, 3, 1, 2), k, st, padding=k // 2).permute(0, 2, 3, 1)
        return apply_act(y, self.cfg.get("act_func"))


class IdentityLayer(nn.Module):
    def __init__(self, cfg=None, *, generator=None):
        super().__init__()

    def forward(self, x, **bn):
        return x


class ZeroLayer(nn.Module):
    """Zeros at h // stride (floor, as the reference's padding computes)."""

    def __init__(self, cfg, *, generator=None):
        super().__init__()
        self.stride = cfg.get("stride", 1)

    def forward(self, x, **bn):
        h, w = x.shape[1] // self.stride, x.shape[2] // self.stride
        return torch.zeros_like(x[:, :h, :w, :])


class LinearLayer(nn.Module):
    """The reference LinearLayer: weight U(-1/sqrt(in), 1/sqrt(in)), zero
    bias (init_model's he_fout zeroes every bias)."""

    def __init__(self, cfg, *, generator):
        super().__init__()
        self.cfg = cfg
        kin = cfg["in_features"]
        self.linear = nn.Linear(kin, cfg["out_features"], bias=cfg.get("bias", True))
        with torch.no_grad():
            self.linear.weight.copy_((torch.rand(self.linear.weight.shape, generator=generator)
                                      * 2 - 1) / kin ** 0.5)
            if self.linear.bias is not None:
                self.linear.bias.zero_()

    def forward(self, x, **bn):
        return apply_act(self.linear(x), self.cfg.get("act_func"))


class MBInvertedConvLayer(nn.Module):
    """The reference MBInvertedConvLayer: optional 1x1 expand -> depthwise
    (+SE) -> 1x1 project, BN after each conv."""

    def __init__(self, cfg, *, generator):
        super().__init__()
        self.cfg = cfg
        cin, out = cfg["in_channels"], cfg["out_channels"]
        mid = cfg.get("mid_channels") or round(cin * cfg["expand_ratio"])
        if cfg["expand_ratio"] != 1:
            self.inverted_bottleneck = ConvBN(conv_init(1, cin, mid, generator=generator))
        self.depth_conv = ConvBN(depthwise_conv_init(cfg["kernel_size"], mid,
                                                     generator=generator))
        if cfg.get("use_se", False):
            self.depth_conv.se = SEModule(mid, generator=generator)
        self.point_linear = ConvBN(conv_init(1, mid, out, generator=generator))

    def forward(self, x, **bn):
        act = self.cfg.get("act_func", "relu6")
        y = x
        if hasattr(self, "inverted_bottleneck"):
            ib = self.inverted_bottleneck
            y = apply_act(bn_apply(conv2d(y, ib.conv.weight), ib.bn, **bn), act)
        dw = self.depth_conv
        y = depthwise_conv2d(y, dw.conv.weight, self.cfg.get("stride", 1))
        y = apply_act(bn_apply(y, dw.bn, **bn), act)
        if hasattr(dw, "se"):
            y = dw.se(y)
        pl = self.point_linear
        return bn_apply(conv2d(y, pl.conv.weight), pl.bn, **bn)


# the reference's name2layer registry
LAYER_REGISTRY = {
    "ConvLayer": ConvLayer,
    "DepthConvLayer": DepthConvLayer,
    "PoolingLayer": PoolingLayer,
    "IdentityLayer": IdentityLayer,
    "LinearLayer": LinearLayer,
    "ZeroLayer": ZeroLayer,
    "MBInvertedConvLayer": MBInvertedConvLayer,
}


def layer_from_config(cfg, *, generator):
    """The reference's set_layer_from_config (None for a None config)."""
    if cfg is None:
        return None
    return LAYER_REGISTRY[cfg["name"]](cfg, generator=generator)


class StaticBlock(nn.Module):
    """The reference MobileInvertedResidualBlock of a static net."""

    def __init__(self, cfg, *, generator):
        super().__init__()
        self.mobile_inverted_conv = layer_from_config(cfg["mobile_inverted_conv"],
                                                      generator=generator)
        sc = cfg.get("shortcut")
        self.identity = sc is not None and sc["name"] == "IdentityLayer"

    def forward(self, x, **bn):
        y = self.mobile_inverted_conv(x, **bn)
        return y + x if self.identity else y


class StaticNetFromConfig(nn.Module):
    """A concrete (non-elastic) classification net built from a reference
    net.config dict, of the MobileNetV3 or the ProxylessNASNets schema."""

    SUPPORTED = ("MobileNetV3", "ProxylessNASNets")

    def __init__(self, config: dict, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """Weights drawn on the CPU from `generator` (seed 0 if None), then
        moved to `device`."""
        super().__init__()
        if config["name"] not in self.SUPPORTED:
            raise ValueError("unsupported net.config name: %r (supported %s)"
                             % (config["name"], self.SUPPORTED))
        self.config = config
        self.is_mbv3 = config["name"] == "MobileNetV3"
        bn = config.get("bn", {})
        self.bn_cfg = {"momentum": bn.get("momentum", 0.1),
                       "eps": bn.get("eps", 1e-5 if self.is_mbv3 else 1e-3)}
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.first_conv = layer_from_config(config["first_conv"], generator=g)
        self.blocks = nn.ModuleList(StaticBlock(b, generator=g) for b in config["blocks"])
        if self.is_mbv3:
            self.final_expand_layer = layer_from_config(config["final_expand_layer"],
                                                        generator=g)
        if config.get("feature_mix_layer") is not None:
            self.feature_mix_layer = layer_from_config(config["feature_mix_layer"],
                                                       generator=g)
        self.classifier = layer_from_config(config["classifier"], generator=g)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum, m.eps = self.bn_cfg["momentum"], self.bn_cfg["eps"]
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x, *, training=False, use_kernels=None):
        """Logits of NHWC images x; `training`: train-mode BN (batch
        moments, running statistics updated in place), through the
        BN-forward kernel on a CUDA net unless `use_kernels=False`."""
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        bn = dict(bn_training=training, use_kernels=use_kernels)
        y = self.first_conv(x, **bn)
        for blk in self.blocks:
            y = blk(y, **bn)
        if self.is_mbv3:
            y = self.final_expand_layer(y, **bn).mean(dim=(1, 2), keepdim=True)
            y = self.feature_mix_layer(y, **bn)[:, 0, 0, :]
        else:
            if hasattr(self, "feature_mix_layer"):
                y = self.feature_mix_layer(y, **bn)
            y = y.mean(dim=(1, 2))
        return self.classifier(y, **bn)


def build_from_config(config: dict, *, device="cuda", generator=None) -> StaticNetFromConfig:
    """The reference's <Net>.build_from_config dispatch."""
    return StaticNetFromConfig(config, device=device, generator=generator)


def load_net_config(path: str, *, device="cuda") -> StaticNetFromConfig:
    with open(path) as f:
        return build_from_config(json.load(f), device=device)


# -- config extraction from an elastic supernet, and weight transfer --------

def get_active_net_config(net, arch) -> dict:
    """ElasticClassifierNet + ClsArch -> the reference-schema net.config of
    the active subnet (the JAX package's dict, key for key)."""
    a = net.arch_to_device(arch)
    wid = len(net.width_mult_list) - 1 if arch.wid is None else arch.wid
    ins, outs = net.active_block_channels(wid)
    fw, fbo, fm_w = a["first_w"], a["fb_out"], a["fm_w"]

    def conv_cfg(in_ch, out_ch, k, stride, act, use_bn=True, bias=False):
        return {"name": "ConvLayer", "kernel_size": k, "stride": stride,
                "dilation": 1, "groups": 1, "bias": bias,
                "has_shuffle": False, "in_channels": in_ch,
                "out_channels": out_ch, "use_bn": use_bn, "act_func": act,
                "dropout_rate": 0, "ops_order": "weight_bn_act"}

    def mb_cfg(in_ch, out_ch, k, stride, e, mid, act, use_se):
        return {"name": "MBInvertedConvLayer", "in_channels": in_ch,
                "out_channels": out_ch, "kernel_size": k, "stride": stride,
                "expand_ratio": e, "mid_channels": mid, "act_func": act,
                "use_se": use_se}

    def block_cfg(mic, shortcut):
        return {"name": "MobileInvertedResidualBlock",
                "mobile_inverted_conv": mic,
                "shortcut": ({"name": "IdentityLayer",
                              "in_channels": mic["out_channels"],
                              "out_channels": mic["out_channels"]}
                             if shortcut else None)}

    # the static e1-k3 first block, mid_channels None like the reference's
    blocks = [block_cfg(mb_cfg(fw, fbo, 3, 1, 1, None, net.first_block_act, False), fbo == fw)]
    bi = 0
    for si, spec in enumerate(net.stage_specs):
        for i in range(spec.n_block):
            if i == 0 or i < arch.d[si]:
                in_ch, out_ch = ins[bi], outs[bi]
                stride = spec.stride if i == 0 else 1
                blocks.append(block_cfg(
                    mb_cfg(in_ch, out_ch, arch.ks[bi], stride, arch.e[bi], a["mid"][bi],
                           spec.act, spec.se),
                    stride == 1 and in_ch == out_ch))
            bi += 1

    head_in = outs[-1]
    cfg = {"name": "MobileNetV3" if net.final_expand_width else "ProxylessNASNets",
           "bn": {"momentum": net.bn_cfg["momentum"], "eps": net.bn_cfg["eps"]},
           "first_conv": conv_cfg(3, fw, 3, 2, net.first_conv_act),
           "blocks": blocks,
           "classifier": {"name": "LinearLayer",
                          "in_features": (net.feature_mix_width if net.final_expand_width
                                          else fm_w),
                          "out_features": net.n_classes, "bias": True,
                          "use_bn": False, "act_func": None,
                          "dropout_rate": net.dropout_rate,
                          "ops_order": "weight_bn_act"}}
    if net.final_expand_width:
        cfg["final_expand_layer"] = conv_cfg(head_in, net.final_expand_width, 1, 1,
                                             net.head_act)
        cfg["feature_mix_layer"] = conv_cfg(net.final_expand_width, net.feature_mix_width,
                                            1, 1, net.head_act, use_bn=False)
    else:
        cfg["feature_mix_layer"] = conv_cfg(head_in, fm_w, 1, 1, net.head_act)
    return cfg


def _put_conv_bn(sd, prefix, conv_w, bn, n=None):
    sd[prefix + ".conv.weight"] = conv_w
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd["%s.bn.%s" % (prefix, name)] = getattr(bn, name)[:n]
    sd[prefix + ".bn.num_batches_tracked"] = bn.num_batches_tracked


def static_params_from_supernet(net, arch) -> dict:
    """The supernet's weight banks sliced into the state_dict of the static
    net that `get_active_net_config(net, arch)` builds (the reference's
    get_active_subnet(preserve_weight=True)); copies, on the supernet's
    device."""
    a = net.arch_to_device(arch)
    fw, fbo, fm_w = a["first_w"], a["fb_out"], a["fm_w"]
    sd = {}
    with torch.no_grad():
        _put_conv_bn(sd, "first_conv", net.first_conv.conv.weight[:fw], net.first_conv.bn, fw)
        fb = net.blocks[0].mobile_inverted_conv
        pre = "blocks.0.mobile_inverted_conv."
        _put_conv_bn(sd, pre + "depth_conv", fb.depth_conv.conv.weight[:fw], fb.depth_conv.bn,
                     fw)
        _put_conv_bn(sd, pre + "point_linear", fb.point_linear.conv.weight[:fbo, :fw],
                     fb.point_linear.bn, fbo)
        wid = len(net.width_mult_list) - 1 if arch.wid is None else arch.wid
        ins, outs = net.active_block_channels(wid)
        bi, si_out = 0, 1
        for si, spec in enumerate(net.stage_specs):
            for i in range(spec.n_block):
                if i == 0 or i < arch.d[si]:
                    in_ch, out_ch, mid = ins[bi], outs[bi], a["mid"][bi]
                    layer = net.blocks[1 + bi].mobile_inverted_conv
                    pre = "blocks.%d.mobile_inverted_conv." % si_out
                    ib, dw, pl = layer.inverted_bottleneck, layer.depth_conv, layer.point_linear
                    _put_conv_bn(sd, pre + "inverted_bottleneck", ib.conv.weight[:mid, :in_ch],
                                 ib.bn, mid)
                    _put_conv_bn(sd, pre + "depth_conv",
                                 layer.active_depthwise(arch.ks[bi])[:mid], dw.bn, mid)
                    _put_conv_bn(sd, pre + "point_linear", pl.conv.weight[:out_ch, :mid], pl.bn,
                                 out_ch)
                    if hasattr(dw, "se"):
                        se_mid, r, e = a["se_mid"][bi], dw.se.fc.reduce, dw.se.fc.expand
                        sep = pre + "depth_conv.se.fc."
                        sd[sep + "reduce.weight"] = r.weight[:se_mid, :mid]
                        sd[sep + "reduce.bias"] = r.bias[:se_mid]
                        sd[sep + "expand.weight"] = e.weight[:mid, :se_mid]
                        sd[sep + "expand.bias"] = e.bias[:mid]
                    si_out += 1
                bi += 1
        head_in = outs[-1]
        lin = net.classifier.linear
        if net.final_expand_width:
            fe = net.final_expand_layer
            _put_conv_bn(sd, "final_expand_layer", fe.conv.weight[:, :head_in], fe.bn)
            sd["feature_mix_layer.conv.weight"] = net.feature_mix_layer.conv.weight
            cls_in = net.feature_mix_width
        else:
            fm = net.feature_mix_layer
            _put_conv_bn(sd, "feature_mix_layer", fm.conv.weight[:fm_w, :head_in], fm.bn, fm_w)
            cls_in = fm_w
        sd["classifier.linear.weight"] = lin.weight[:, :cls_in]
        sd["classifier.linear.bias"] = lin.bias
        return {k: v.detach().clone() for k, v in sd.items()}


def specialize(net, arch) -> StaticNetFromConfig:
    """One-call deployment: the static net of the active subnet, with the
    supernet's sliced weights, on the supernet's device (the JAX package's
    returns its (static net, params, state); here the weights live in the
    module)."""
    static = build_from_config(get_active_net_config(net, arch), device=net.device)
    static.load_state_dict(static_params_from_supernet(net, arch))
    return static


def import_torch_static(path_or_sd, static_net: StaticNetFromConfig) -> StaticNetFromConfig:
    """Load a reference specialized-net state_dict (a path to a `.pth.tar`
    with {"state_dict"} or {"model"}, or the dict itself) into `static_net`,
    whose layout it already has; returns the net."""
    from ..train.checkpoint import checkpoint_state_dict

    ckpt = path_or_sd
    if not isinstance(ckpt, dict):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=True)
    own = static_net.state_dict()
    sd = {k: torch.as_tensor(v) for k, v in checkpoint_state_dict(ckpt).items()}
    # reference files predate num_batches_tracked: keep the net's
    sd.update({k: own[k] for k in own if k.endswith("num_batches_tracked") and k not in sd})
    static_net.load_state_dict(sd)
    return static_net
