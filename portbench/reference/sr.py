"""Plain PyTorch reference of the once-for-all super-resolution supernet
OFAMobileNetS4 (twice154/ofa-for-super-resolution,
ofa/elastic_nn/networks/ofa_mbs4.py), NCHW, float32.

Topology: 5x5 conv 3 -> width, BN (the long skip saved) -> n_stages
elastic stages of up to max(depth_list) MBConv blocks (1x1 expand to
make_divisible(round(width * e), 8), BN, relu6; k x k depthwise, BN,
relu6; 1x1 project, BN; identity shortcut), the first d of a stage run ->
two 5x5 convs width -> width with BN, the long skip added after the first
-> pixel_d times [5x5 conv width -> 4 width, BN, PixelShuffle(2)] -> 5x5
conv width -> 3, BN. The elastic kernel: a k x k kernel is the centre of
the next larger one through a learned (k^2 x k^2) matrix, from the 7x7 bank
down (`active_kernel`). A subnet slices each bank to its widths and taps.

Parameter names are the published state dict's. `rounding` rounds every
product's operands and result (none, or a control's: `precision`);
`dtype` is float32, or float64 to see how far float32 itself lies from
the exact result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import ROUNDINGS


def make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def mid_width(cfg, e):
    return make_divisible(round(cfg["width"] * e))


def blocks_per_trunk(cfg):
    return cfg["n_stages"] * max(cfg["depth_list"])


def param_shapes(cfg):
    """{name: shape} of the supernet's parameters and BN buffers."""
    w, ck = cfg["width"], cfg["conv_ks"]
    mid = mid_width(cfg, max(cfg["expand_list"]))
    kmax = max(cfg["ks_list"])
    out = {}

    def conv_bn(prefix, cout, cin, k):
        out[prefix + ".conv.weight"] = (cout, cin, k, k)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[prefix + ".bn." + leaf] = (cout,)
        out[prefix + ".bn.num_batches_tracked"] = ()

    conv_bn("dec_first_conv_block", w, 3, ck)
    ks = sorted(cfg["ks_list"])
    n_mb = blocks_per_trunk(cfg)
    for b in range(n_mb):
        p = "blocks.%d.mobile_inverted_conv." % b
        conv_bn(p + "inverted_bottleneck", mid, w, 1)
        conv_bn(p + "depth_conv", mid, 1, kmax)
        for big, small in zip(ks[:0:-1], ks[-2::-1]):
            out[p + "depth_conv.conv.%dto%d_matrix" % (big, small)] = (small * small,) * 2
        conv_bn(p + "point_linear", w, mid, 1)
    for i in range(2):
        conv_bn("dec_final_conv_blocks.%d" % i, w, w, ck)
    for i in range(max(cfg["pixel_d_list"])):
        conv_bn("blocks.%d" % (n_mb + i), 4 * w, w, ck)
    conv_bn("dec_final_output_conv_block", 3, w, ck)
    return out


def active_kernel(bank, mats, ks_list, k):
    """The effective k x k depthwise kernel of a [C, 1, K, K] bank: the
    centre of each larger kernel through its transform matrix (x @ M.T
    over the row-major taps), largest first."""
    ks = sorted(ks_list)
    w = bank
    for i in range(len(ks) - 1, 0, -1):
        if ks[i] <= k:
            break
        small = ks[i - 1]
        s = (w.shape[-1] - small) // 2
        c = w[:, :, s:s + small, s:s + small]
        w = (c.reshape(-1, small * small) @ mats["%dto%d" % (ks[i], small)].T).reshape(
            c.shape)
    return w


class S4:
    """The supernet over a {name: tensor} state; `params` are float32
    leaves (`requires_grad`), the BN running statistics plain tensors."""

    def __init__(self, cfg, state, rounding=ROUNDINGS["float32"], requires_grad=True,
                 dtype=torch.float32):
        self.cfg, (self.q, self.qr), self.dtype = cfg, rounding, dtype
        self.t = {}
        for name in param_shapes(cfg):
            v = state[name].detach().clone()
            if v.is_floating_point():
                v = v.to(dtype)
                if not name.split(".")[-1].startswith("running"):
                    v.requires_grad_(requires_grad)
            self.t[name] = v

    def named_parameters(self):
        return [(n, v) for n, v in self.t.items() if v.is_floating_point()
                and v.requires_grad]

    def conv(self, x, w, groups=1):
        return self.qr(F.conv2d(self.q(x), self.q(w), padding=w.shape[-1] // 2, groups=groups))

    def bn(self, x, prefix, n, train):
        """BN over the first n channels: batch moments (biased variance)
        in train mode, else the running statistics."""
        g = self.t[prefix + ".bn.weight"][:n]
        b = self.t[prefix + ".bn.bias"][:n]
        eps = self.cfg["bn_eps"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean = self.t[prefix + ".bn.running_mean"][:n]
            var = self.t[prefix + ".bn.running_var"][:n]
        inv = torch.rsqrt(var + eps)
        return (x - mean[:, None, None]) * (inv * g)[:, None, None] + b[:, None, None]

    def conv_bn(self, x, prefix, train, cin=None, cout=None):
        w = self.t[prefix + ".conv.weight"][:cout, :cin]
        return self.bn(self.conv(x, w), prefix, w.shape[0], train)

    def mbconv(self, x, b, k, mid, train):
        p = "blocks.%d.mobile_inverted_conv." % b
        y = torch.clamp(self.conv_bn(x, p + "inverted_bottleneck", train, cout=mid), 0, 6)
        mats = {n.rsplit(".", 1)[1][:-len("_matrix")]: v for n, v in self.t.items()
                if n.startswith(p + "depth_conv.conv.") and n.endswith("_matrix")}
        wk = active_kernel(self.t[p + "depth_conv.conv.weight"][:mid], mats, self.cfg["ks_list"], k)
        y = torch.clamp(self.bn(self.conv(y, wk, groups=mid), p + "depth_conv", mid, train), 0, 6)
        return self.conv_bn(y, p + "point_linear", train, cin=mid) + x

    def forward(self, x_nhwc, subnet, train):
        """The HR output (NHWC) of `subnet` ({"ks", "e", "d", "pixel_d"}) on
        an NHWC LR batch."""
        cfg = self.cfg
        md = max(cfg["depth_list"])
        x = x_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        y = self.conv_bn(x, "dec_first_conv_block", train)
        skip = y
        for s in range(cfg["n_stages"]):
            for i in range(subnet["d"][s]):
                bi = s * md + i
                y = self.mbconv(y, bi, subnet["ks"][bi], mid_width(cfg, subnet["e"][bi]), train)
        y = self.conv_bn(y, "dec_final_conv_blocks.0", train) + skip
        y = self.conv_bn(y, "dec_final_conv_blocks.1", train)
        n_mb = blocks_per_trunk(cfg)
        for i in range(subnet["pixel_d"]):
            y = F.pixel_shuffle(self.conv_bn(y, "blocks.%d" % (n_mb + i), train), 2)
        y = self.conv_bn(y, "dec_final_output_conv_block", train)
        return y.permute(0, 2, 3, 1)


def train_loss(net, batch, subnet):
    """A subnet's MSE against the HR frames, on the LR input its pixel_d
    selects."""
    out = net.forward(batch["x%d" % 2 ** subnet["pixel_d"]], subnet, train=True)
    return torch.mean(torch.square(out - batch["image"].to(out.dtype)))
