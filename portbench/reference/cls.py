"""Plain PyTorch reference of the once-for-all classification supernets
(mit-han-lab/once-for-all: OFAMobileNetV3, and OFAProxylessNASNets by the
same configuration keys), NCHW, float32.

Topology from the configuration: 3x3 stride-2 conv to `first_conv_width`
(BN, `first_conv_act`) -> the static first block (3x3 depthwise, BN,
`first_block_act`; 1x1 to `first_block_width`, BN; an identity shortcut
where the width is kept) -> `stages` of elastic MBConv blocks ([width,
stride, act, se, blocks]: 1x1 expand to make_divisible(round(in * e), 8),
BN, act; k x k depthwise at the stage's stride on the first block, BN, act;
squeeze-excite where `se` (mean pool, 1x1 to make_divisible(mid // 4, 8)
with bias, ReLU, 1x1 back with bias, h_sigmoid gate); 1x1 project, BN; an
identity shortcut but on a stage's first block), the first block of a
stage always and the rest up to its depth -> `final_expand_width` 1x1 (BN,
`head_act`), mean pool, `feature_mix_width` 1x1 without BN (`head_act`),
or (no final expand) the feature mix with BN before the pool -> dropout
-> the linear classifier. The elastic kernel as in `sr.active_kernel`.

Parameter names are the published state dict's. `rounding` rounds every
product's operands and result; `dtype` float32, or float64 to see how far float32
itself lies from the exact result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import ROUNDINGS
from .sr import active_kernel, make_divisible

ACTS = {
    "relu": lambda x: torch.clamp(x, min=0),
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "h_swish": lambda x: x * torch.clamp(x + 3, 0, 6) / 6,
}


def h_sigmoid(x):
    return torch.clamp(x + 3, 0, 6) / 6


def param_shapes(cfg, ks_list=None, expand_list=None, depth_list=None):
    """{name: shape} of the supernet's parameters and BN buffers, for the
    configuration's candidate lists or the ones given (a KD teacher's)."""
    ks = sorted(ks_list or cfg["ks_list"])
    e_max = max(expand_list or cfg["expand_list"])
    d_max = max(depth_list or cfg["depth_list"])
    out = {}

    def bn(prefix, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[prefix + ".bn." + leaf] = (c,)
        out[prefix + ".bn.num_batches_tracked"] = ()

    w0 = cfg["first_conv_width"]
    fb = cfg.get("first_block_width") or w0
    out["first_conv.conv.weight"] = (w0, 3, 3, 3)
    bn("first_conv", w0)
    p = "blocks.0.mobile_inverted_conv."
    out[p + "depth_conv.conv.weight"] = (w0, 1, 3, 3)
    bn(p + "depth_conv", w0)
    out[p + "point_linear.conv.weight"] = (fb, w0, 1, 1)
    bn(p + "point_linear", fb)
    in_ch, b = fb, 1
    for width, _, _, se, n_block in cfg["stages"]:
        for _ in range(min(n_block, d_max)):
            p = "blocks.%d.mobile_inverted_conv." % b
            mid = round(in_ch * e_max)
            out[p + "inverted_bottleneck.conv.weight"] = (mid, in_ch, 1, 1)
            bn(p + "inverted_bottleneck", mid)
            out[p + "depth_conv.conv.weight"] = (mid, 1, max(ks), max(ks))
            for big, small in zip(ks[:0:-1], ks[-2::-1]):
                out[p + "depth_conv.conv.%dto%d_matrix" % (big, small)] = (small * small,) * 2
            bn(p + "depth_conv", mid)
            if se:
                se_mid = make_divisible(mid // 4)
                out[p + "depth_conv.se.fc.reduce.weight"] = (se_mid, mid, 1, 1)
                out[p + "depth_conv.se.fc.reduce.bias"] = (se_mid,)
                out[p + "depth_conv.se.fc.expand.weight"] = (mid, se_mid, 1, 1)
                out[p + "depth_conv.se.fc.expand.bias"] = (mid,)
            out[p + "point_linear.conv.weight"] = (width, mid, 1, 1)
            bn(p + "point_linear", width)
            in_ch, b = width, b + 1
    if cfg.get("final_expand_width"):
        out["final_expand_layer.conv.weight"] = (cfg["final_expand_width"], in_ch, 1, 1)
        bn("final_expand_layer", cfg["final_expand_width"])
        out["feature_mix_layer.conv.weight"] = (cfg["feature_mix_width"],
                                                cfg["final_expand_width"], 1, 1)
    else:
        out["feature_mix_layer.conv.weight"] = (cfg["feature_mix_width"], in_ch, 1, 1)
        bn("feature_mix_layer", cfg["feature_mix_width"])
    out["classifier.linear.weight"] = (cfg["n_classes"], cfg["feature_mix_width"])
    out["classifier.linear.bias"] = (cfg["n_classes"],)
    return out


class Classifier:
    """The supernet over a {name: tensor} state (float32 leaves, BN running
    statistics plain)."""

    def __init__(self, cfg, state, rounding=ROUNDINGS["float32"], requires_grad=True,
                 ks_list=None, expand_list=None, depth_list=None, dtype=torch.float32):
        self.cfg, (self.q, self.qr), self.dtype = cfg, rounding, dtype
        self.ks_list = sorted(ks_list or cfg["ks_list"])
        names = param_shapes(cfg, ks_list, expand_list, depth_list)
        self.t = {}
        for name in names:
            v = state[name].detach().clone()
            if v.is_floating_point():
                v = v.to(dtype)
                if not name.split(".")[-1].startswith("running"):
                    v.requires_grad_(requires_grad)
            self.t[name] = v

    def named_parameters(self):
        return [(n, v) for n, v in self.t.items() if v.is_floating_point() and v.requires_grad]

    def conv(self, x, w, stride=1, groups=1, bias=None):
        return self.qr(F.conv2d(self.q(x), self.q(w), bias, stride=stride,
                                padding=w.shape[-1] // 2, groups=groups))

    def bn(self, x, prefix, n, train):
        g = self.t[prefix + ".bn.weight"][:n]
        b = self.t[prefix + ".bn.bias"][:n]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean = self.t[prefix + ".bn.running_mean"][:n]
            var = self.t[prefix + ".bn.running_var"][:n]
        inv = torch.rsqrt(var + self.cfg["bn_eps"])
        return (x - mean[:, None, None]) * (inv * g)[:, None, None] + b[:, None, None]

    def conv_bn(self, x, prefix, train, cout=None, cin=None, stride=1):
        w = self.t[prefix + ".conv.weight"][:cout, :cin]
        return self.bn(self.conv(x, w, stride), prefix, w.shape[0], train)

    def mbconv(self, x, b, k, e, act, stride, se, train):
        p = "blocks.%d.mobile_inverted_conv." % b
        in_ch = x.shape[1]
        mid = make_divisible(round(in_ch * e))
        f = ACTS[act]
        y = f(self.conv_bn(x, p + "inverted_bottleneck", train, cout=mid, cin=in_ch))
        mats = {n.rsplit(".", 1)[1][:-len("_matrix")]: v for n, v in self.t.items()
                if n.startswith(p + "depth_conv.conv.") and n.endswith("_matrix")}
        wk = active_kernel(self.t[p + "depth_conv.conv.weight"][:mid], mats, self.ks_list, k)
        y = f(self.bn(self.conv(y, wk, stride, groups=mid), p + "depth_conv", mid, train))
        if se:
            s_mid = make_divisible(mid // 4)
            r = p + "depth_conv.se.fc.reduce."
            ex = p + "depth_conv.se.fc.expand."
            g = y.mean(dim=(2, 3), keepdim=True)
            g = torch.clamp(self.conv(g, self.t[r + "weight"][:s_mid, :mid],
                                      bias=self.t[r + "bias"][:s_mid]), min=0)
            g = self.conv(g, self.t[ex + "weight"][:mid, :s_mid], bias=self.t[ex + "bias"][:mid])
            y = y * h_sigmoid(g)
        return self.conv_bn(y, p + "point_linear", train, cin=mid)

    def forward(self, x_nhwc, arch, train, dropout=None):
        """Logits of `arch` ({"ks", "e", "d"}) on NHWC images; `dropout`:
        the keep mask of the pooled features (None: no dropout)."""
        cfg = self.cfg
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        y = ACTS[cfg["first_conv_act"]](self.conv_bn(x, "first_conv", train, stride=2))
        p = "blocks.0.mobile_inverted_conv."
        w0 = y.shape[1]
        h = ACTS[cfg["first_block_act"]](self.bn(
            self.conv(y, self.t[p + "depth_conv.conv.weight"], groups=w0), p + "depth_conv", w0,
            train))
        h = self.conv_bn(h, p + "point_linear", train)
        y = y + h if h.shape[1] == w0 else h
        b = 1
        for si, (width, stride, act, se, n_block) in enumerate(cfg["stages"]):
            for i in range(n_block):
                if i == 0 or i < arch["d"][si]:
                    out = self.mbconv(y, b, arch["ks"][b - 1], arch["e"][b - 1], act,
                                      stride if i == 0 else 1, se, train)
                    y = out if i == 0 else out + y
                b += 1
        head = ACTS[cfg["head_act"]]
        if cfg.get("final_expand_width"):
            y = head(self.conv_bn(y, "final_expand_layer", train))
            y = y.mean(dim=(2, 3), keepdim=True)
            y = head(self.conv(y, self.t["feature_mix_layer.conv.weight"]))[:, :, 0, 0]
        else:
            y = head(self.conv_bn(y, "feature_mix_layer", train)).mean(dim=(2, 3))
        if dropout is not None:
            keep = 1.0 - cfg["dropout_rate"]
            y = torch.where(dropout, y / keep, torch.zeros_like(y))
        return self.qr(F.linear(self.q(y), self.q(self.t["classifier.linear.weight"]),
                                self.t["classifier.linear.bias"]))


def cross_entropy(logits, labels, smoothing):
    """Mean cross-entropy against the one-hot labels mixed with the uniform
    target by `smoothing`."""
    n = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    soft = F.one_hot(labels, n).to(logp.dtype) * (1 - smoothing) + smoothing / n
    return -(soft * logp).sum(-1).mean()


def kd_loss(logits, teacher_prob):
    """Mean soft-target cross-entropy against the teacher's softmax."""
    return -(teacher_prob.to(logits.dtype) * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
