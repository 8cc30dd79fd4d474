"""Materialize a static subnet from the supernet weight banks: the serving
path. Counterpart of ofa_sr_tpu/models/materialize.py (`mode="sr"`).

Slice the active kernel (through the transform chain), the active middle
channels and the BN prefix into concrete tensors, optionally fold eval-mode
BN into the convs (`fold_bn`: w' = w * gamma/sqrt(var+eps),
b' = beta - mean*gamma/sqrt(var+eps)), and run frames through the small
static net.

`use_kernels` (default: on for a CUDA net with folded BN) routes every MBConv
block through the fused MBConv kernel and every shuffle layer through the
fused conv5x5+PixelShuffle kernel (ops/kernels/). As in the JAX package, the
kernels need folded BN (asking for them with `fold_bn=False` raises), and
they turn `fold_tail` off.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.activations import apply_act
from ..ops.conv import conv2d, depthwise_conv2d
from ..ops.kernels import fused_mbconv_infer, fused_shuffle_tail
from ..ops.norm import batch_norm
from ..ops.pixelshuffle import pixel_shuffle
from .arch import SearchSpace, SubnetConfig


def _slice_bn(bn, n=None):
    return {"scale": bn.weight[:n], "bias": bn.bias[:n],
            "mean": bn.running_mean[:n], "var": bn.running_var[:n]}


def _fold_bn_into_conv(w, bn, eps):
    """(w', bias') folding eval-mode BN (a `_slice_bn` dict) into an OIHW
    conv."""
    inv = 1.0 / torch.sqrt(bn["var"] + eps)
    g = bn["scale"] * inv
    return w * g[:, None, None, None], bn["bias"] - bn["mean"] * g


def _materialize_conv(w, bn, *, fold_bn, eps):
    if fold_bn:
        w, b = _fold_bn_into_conv(w, bn, eps)
        return {"w": w, "b": b}
    return {"w": w, "bn": bn}


def _materialize_conv_layer(layer, *, fold_bn, eps):
    return _materialize_conv(layer.conv.weight, _slice_bn(layer.bn),
                             fold_bn=fold_bn, eps=eps)


def _materialize_mbconv(layer, space: SearchSpace, ks: int, expand, *,
                        fold_bn, eps):
    """Slice one DynamicMBConvLayer into static weights: transform-chain
    kernel + prefix slices + BN."""
    mid = space.mid_channels(expand)
    ib, dw, pl = layer.inverted_bottleneck, layer.depth_conv, layer.point_linear
    fb = dict(fold_bn=fold_bn, eps=eps)
    return {
        "ks": ks, "mid": mid,
        "ib": _materialize_conv(ib.conv.weight[:mid], _slice_bn(ib.bn, mid), **fb),
        "dw": _materialize_conv(layer.active_depthwise(ks)[:mid],
                                _slice_bn(dw.bn, mid), **fb),
        "pl": _materialize_conv(pl.conv.weight[:, :mid], _slice_bn(pl.bn), **fb),
    }


def _fold_conv_through_shuffle(w, b, r=2):
    """Rewrite `conv_k(pixel_shuffle(z, r))` as
    `pixel_shuffle(conv_k'(z, W'), r)`, exact for odd k with SAME padding.

    Output HR row r*I+p reads HR row r*I+p+u-pad for tap u; as r*(I+di)+a
    that is the unique LR tap di = (p+u-pad)//r at sub-pixel row
    a = (p+u-pad)%r. With pixel_shuffle's channel order (LR channel
    c*r^2 + y*r + x is HR channel c at (y, x)), for OIHW weights:
    W'[co*r^2+p*r+q, ci*r^2+a*r+bb, di, dj] = W[co, ci, u, v] and
    b'[co*r^2+p*r+q] = b[co]. For k=5: k'=3 with 4x the channels."""
    cout, cin, k, k2 = w.shape
    assert k == k2 and k % 2 == 1, "odd square kernels only"
    pad = k // 2
    taps = [(p + u - pad) // r for p in range(r) for u in range(k)]
    di_min, di_max = min(taps), max(taps)
    kf = di_max - di_min + 1
    assert kf // 2 == -di_min, "folded kernel must stay SAME-paddable"
    wf = w.new_zeros(cout * r * r, cin * r * r, kf, kf)
    for p in range(r):
        for q in range(r):
            for u in range(k):
                for v in range(k):
                    t, s_ = p + u - pad, q + v - pad
                    ti, a = t // r - di_min, t % r
                    si, bb = s_ // r - di_min, s_ % r
                    wf[p * r + q::r * r, a * r + bb::r * r, ti, si] = w[:, :, u, v]
    return wf, b.repeat_interleave(r * r)


def _channels_last(lp):
    """The convs get channels-last inputs (NHWC views); a weight stored in
    the same memory format is not converted by PyTorch on every call."""
    return {k: (v.contiguous(memory_format=torch.channels_last)
                if k == "w" else v) for k, v in lp.items()}


def _kernel_mbconv_args(bp):
    """The fused MBConv kernel's operands from a folded block: ib_w [C,M],
    ib_b, dw_w [k,k,M], dw_b, pl_w [M,C], pl_b, all contiguous."""
    ib, dw, pl = bp["ib"], bp["dw"], bp["pl"]
    return (ib["w"][:, :, 0, 0].t().contiguous(), ib["b"].contiguous(),
            dw["w"][:, 0].permute(1, 2, 0).contiguous(), dw["b"].contiguous(),
            pl["w"][:, :, 0, 0].t().contiguous(), pl["b"].contiguous())


class StaticSubnet:
    """A concrete (non-elastic) SR net sliced out of an OFAMobileNetS4."""

    def __init__(self, net, cfg: SubnetConfig, *, fold_bn: bool = True,
                 mode: str = "sr", use_kernels: Optional[bool] = None,
                 fold_tail: bool = True):
        if mode != "sr":
            raise NotImplementedError(
                "mode=%r (the X4 autoencoder) is not ported yet" % mode)
        sp = self.space = net.space
        self.cfg = cfg
        self.pixel_d = cfg.pixel_d
        self.fold_bn = fold_bn
        self.mode = mode
        self.eps = net.dec_first_conv_block.bn.eps
        self.device = net.device
        # the kernels take folded BN (the JAX package's `use_pallas and
        # fold_bn`), and consume the tail the fold would rewrite
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and fold_bn
        elif use_kernels and not fold_bn:
            raise ValueError("use_kernels=True needs fold_bn=True: the fused "
                             "kernels take BN-folded weights")
        self.use_kernels = use_kernels
        self.fold_tail = (fold_tail and fold_bn and self.pixel_d >= 1
                          and not self.use_kernels)

        fb = dict(fold_bn=fold_bn, eps=self.eps)
        m = {}
        with torch.no_grad():
            m["dec_first"] = _materialize_conv_layer(net.dec_first_conv_block, **fb)
            stages = []
            for stage in range(sp.n_stages):
                blocks = []
                for i in range(cfg.d[stage]):
                    bi = stage * sp.max_depth + i
                    bp = _materialize_mbconv(
                        net.blocks[bi].mobile_inverted_conv, sp, cfg.ks[bi],
                        cfg.e[bi], **fb)
                    if self.use_kernels:
                        bp = {"ks": bp["ks"], "mid": bp["mid"],
                              "kernel": _kernel_mbconv_args(bp)}
                    else:
                        bp.update({k: _channels_last(bp[k]) for k in ("ib", "dw", "pl")})
                    blocks.append(bp)
                stages.append(blocks)
            m["dec_stages"] = stages
            m["dec_final"] = [_channels_last(_materialize_conv_layer(layer, **fb))
                              for layer in net.dec_final_conv_blocks]
            shuffle = []
            for layer in net.shuffle_blocks[:self.pixel_d]:
                lp = _materialize_conv_layer(layer, **fb)
                if self.use_kernels:
                    # the tail kernel's HWIO (5,5,C,4C) operand
                    lp = {"w_hwio": lp["w"].permute(2, 3, 1, 0).contiguous(),
                          "b": lp["b"].contiguous()}
                else:
                    lp = _channels_last(lp)
                shuffle.append(lp)
            m["shuffle"] = shuffle
            m["dec_out"] = _channels_last(
                _materialize_conv_layer(net.dec_final_output_conv_block, **fb))
            if self.fold_tail:
                # the output conv runs before the last pixel_shuffle as a
                # 3x3 256->12 conv at LR: exact, see _fold_conv_through_shuffle
                wf, bf = _fold_conv_through_shuffle(m["dec_out"]["w"],
                                                    m["dec_out"]["b"])
                m["dec_out_folded"] = _channels_last({"w": wf, "b": bf})
        self.params = m

    # -- forward ---------------------------------------------------------------

    def _post(self, lp, y, act=None):
        if self.fold_bn:
            y = y + lp["b"]
        else:
            bn = lp["bn"]
            y = batch_norm(y, bn["scale"], bn["bias"], bn["mean"], bn["var"],
                           eps=self.eps)
        return apply_act(y, act)

    def _conv_layer(self, lp, x, *, shuffle=False):
        y = self._post(lp, conv2d(x, lp["w"]))
        return pixel_shuffle(y, 2) if shuffle else y

    def _mbconv(self, bp, x):
        """One MBConv block with its identity shortcut."""
        if "kernel" in bp:
            return fused_mbconv_infer(x, *bp["kernel"], residual=True)
        y = self._post(bp["ib"], conv2d(x, bp["ib"]["w"]), act="relu6")
        y = self._post(bp["dw"], depthwise_conv2d(y, bp["dw"]["w"]), act="relu6")
        y = self._post(bp["pl"], conv2d(y, bp["pl"]["w"]))
        return y + x

    def __call__(self, x, row_valid=None):
        """x: the LR frame(s), NHWC float32 on the subnet's device."""
        if row_valid is not None:
            raise NotImplementedError(
                "row_valid (spatial-parallel inference) is not ported yet")
        m = self.params
        x = self._conv_layer(m["dec_first"], x)
        skip = x
        for stage in m["dec_stages"]:
            for bp in stage:
                x = self._mbconv(bp, x)
        for i, lp in enumerate(m["dec_final"]):
            x = self._conv_layer(lp, x)
            if i == 0:
                x = x + skip
        for li, lp in enumerate(m["shuffle"]):
            if self.fold_tail and li == len(m["shuffle"]) - 1:
                # keep the last shuffle conv's output at LR (256 ch): the
                # folded output conv consumes the pre-shuffle layout
                x = self._conv_layer(lp, x)
                fold = m["dec_out_folded"]
                return pixel_shuffle(conv2d(x, fold["w"]) + fold["b"], 2)
            if self.use_kernels:
                x = fused_shuffle_tail(x, lp["w_hwio"], lp["b"])
            else:
                x = self._conv_layer(lp, x, shuffle=True)
        return self._conv_layer(m["dec_out"], x)


def get_active_subnet(net, cfg: SubnetConfig, *, fold_bn: bool = True,
                      mode: str = "sr", use_kernels: Optional[bool] = None,
                      fold_tail: bool = True) -> StaticSubnet:
    return StaticSubnet(net, cfg, fold_bn=fold_bn, mode=mode,
                        use_kernels=use_kernels, fold_tail=fold_tail)
