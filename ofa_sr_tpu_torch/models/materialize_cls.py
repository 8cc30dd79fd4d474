"""Materialize a static classification subnet from an ElasticClassifierNet
(counterpart of ofa_sr_tpu/models/materialize_cls.py): the active subnet's
net.config and sliced weights (`net_config.get_active_net_config`,
`static_params_from_supernet`: kernels through the transform chain,
middle channels, SE bottlenecks, widths and BN prefixes), with BN
optionally folded into the convs, eval only. The plain path: the
classification nets have no Pallas kernel in the JAX package, so none
here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.activations import apply_act, h_sigmoid
from ..ops.conv import conv2d, depthwise_conv2d
from ..ops.norm import batch_norm
from .materialize import _materialize_conv
from .net_config import get_active_net_config, static_params_from_supernet
from .ofa_cls import ClsArch, ElasticClassifierNet


class StaticClsSubnet:
    """The subnet `arch` of `net` as static tensors; `subnet(x)` gives the
    logits of NHWC images x."""

    def __init__(self, net: ElasticClassifierNet, arch: ClsArch, *, fold_bn: bool = True):
        self.net = net
        self.arch = arch
        self.fold_bn = fold_bn
        self.eps = net.bn_cfg["eps"]
        cfg = get_active_net_config(net, arch)
        sd = static_params_from_supernet(net, arch)

        def conv_bn(prefix):
            bn = {k: sd["%s.bn.%s" % (prefix, name)] for k, name in (
                ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                ("var", "running_var"))}
            return _materialize_conv(sd[prefix + ".conv.weight"], bn, fold_bn=fold_bn,
                                     eps=self.eps)

        m = {"first_conv": conv_bn("first_conv"), "blocks": []}
        for i, blk in enumerate(cfg["blocks"]):
            mic, pre = blk["mobile_inverted_conv"], "blocks.%d.mobile_inverted_conv." % i
            b = {"stride": mic["stride"], "act": mic["act_func"],
                 "residual": blk["shortcut"] is not None,
                 "dw": conv_bn(pre + "depth_conv"), "pl": conv_bn(pre + "point_linear")}
            if mic["expand_ratio"] != 1:
                b["ib"] = conv_bn(pre + "inverted_bottleneck")
            if mic["use_se"]:
                fc = pre + "depth_conv.se.fc."
                b["se"] = {"rw": sd[fc + "reduce.weight"][:, :, 0, 0],
                           "rb": sd[fc + "reduce.bias"],
                           "ew": sd[fc + "expand.weight"][:, :, 0, 0],
                           "eb": sd[fc + "expand.bias"]}
            m["blocks"].append(b)
        if net.final_expand_width:
            m["final_expand"] = conv_bn("final_expand_layer")
            m["feature_mix"] = {"w": sd["feature_mix_layer.conv.weight"]}
        else:
            m["feature_mix"] = conv_bn("feature_mix_layer")
        m["classifier"] = {"w": sd["classifier.linear.weight"], "b": sd["classifier.linear.bias"]}
        self.params = m

    def _post(self, lp, y, act=None):
        if self.fold_bn:
            y = y + lp["b"]
        else:
            bn = lp["bn"]
            y = batch_norm(y, bn["scale"], bn["bias"], bn["mean"], bn["var"], eps=self.eps)
        return apply_act(y, act)

    def __call__(self, x):
        net, m = self.net, self.params
        y = self._post(m["first_conv"], conv2d(x, m["first_conv"]["w"], stride=2),
                       net.first_conv_act)
        for blk in m["blocks"]:
            z = y
            if "ib" in blk:
                z = self._post(blk["ib"], conv2d(z, blk["ib"]["w"]), blk["act"])
            z = self._post(blk["dw"], depthwise_conv2d(z, blk["dw"]["w"], blk["stride"]),
                           blk["act"])
            if "se" in blk:
                se = blk["se"]
                g = torch.clamp(F.linear(z.mean(dim=(1, 2)), se["rw"], se["rb"]), min=0.0)
                z = z * h_sigmoid(F.linear(g, se["ew"], se["eb"]))[:, None, None, :]
            z = self._post(blk["pl"], conv2d(z, blk["pl"]["w"]))
            y = y + z if blk["residual"] else z
        if net.final_expand_width:
            y = self._post(m["final_expand"], conv2d(y, m["final_expand"]["w"]), net.head_act)
            y = y.mean(dim=(1, 2), keepdim=True)
            y = apply_act(conv2d(y, m["feature_mix"]["w"]), net.head_act)[:, 0, 0, :]
        else:
            y = self._post(m["feature_mix"], conv2d(y, m["feature_mix"]["w"]), net.head_act)
            y = y.mean(dim=(1, 2))
        return F.linear(y, m["classifier"]["w"], m["classifier"]["b"])


def get_active_cls_subnet(net, arch: ClsArch, *, fold_bn: bool = True) -> StaticClsSubnet:
    return StaticClsSubnet(net, arch, fold_bn=fold_bn)
