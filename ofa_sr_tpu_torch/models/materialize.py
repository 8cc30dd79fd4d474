"""Materialize a static subnet from the supernet weight banks: the serving
path. Counterpart of ofa_sr_tpu/models/materialize.py, for the S4 net and
for the X4 net in `mode="sr"` and `mode="autoencoder"`.

Slice the active kernel (through the transform chain), the active middle
channels and the BN prefix into concrete tensors, optionally fold eval-mode
BN into the convs (`fold_bn`: w' = w * gamma/sqrt(var+eps),
b' = beta - mean*gamma/sqrt(var+eps)), and run frames through the small
static net.

`use_kernels` (default: on for a CUDA net with folded BN) routes every MBConv
block through the fused MBConv kernel and every 5x5 shuffle layer (the
S4's) through the fused conv5x5+PixelShuffle kernel (ops/kernels/). As in
the JAX package, the kernels need folded BN (asking for them with
`fold_bn=False` raises), and the tail kernel turns `fold_tail` off.

`subnet(x, row_valid=(lo, hi))` runs a frame whose rows outside [lo, hi)
are not the frame's (row padding, or a slab's halos past the frame edge in
spatial inference, parallel/spatial.py): those rows are re-zeroed before
every spatial conv, so the valid rows come out as the unpadded frame's.
The MBConv kernel takes the bounds itself (its mid activation never leaves
the chip), and the shuffle-tail kernel's input is masked before its
launch, as the JAX package masks the Pallas tail's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.activations import apply_act
from ..ops.conv import conv2d, depthwise_conv2d
from ..ops.kernels import fused_mbconv_infer, fused_shuffle_tail
from ..ops.kernels.shuffle_tail import KS as SHUFFLE_TAIL_KS
from ..ops.norm import batch_norm
from ..ops.pixelshuffle import pixel_shuffle, pixel_unshuffle
from .arch import SearchSpace, SubnetConfig, check_n_trunks
from .layers import shuffle_slot


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


def _row_mask(x, row_valid, f=1):
    """x with the rows outside [lo*f, hi*f) zeroed (x itself for None):
    `row_valid` is (lo, hi) at the input's resolution (LR rows in the
    decoder and the encoder's trunk), `f` the current upscale factor."""
    if row_valid is None:
        return x
    lo, hi = row_valid
    rows = torch.arange(x.shape[1], device=x.device)
    return x * ((rows >= lo * f) & (rows < hi * f)).to(x.dtype)[None, :, None, None]


def _kernel_mbconv_args(bp):
    """The fused MBConv kernel's operands from a folded block: ib_w [C,M],
    ib_b, dw_w [k,k,M], dw_b, pl_w [M,C], pl_b, all contiguous."""
    ib, dw, pl = bp["ib"], bp["dw"], bp["pl"]
    return (ib["w"][:, :, 0, 0].t().contiguous(), ib["b"].contiguous(),
            dw["w"][:, 0].permute(1, 2, 0).contiguous(), dw["b"].contiguous(),
            pl["w"][:, :, 0, 0].t().contiguous(), pl["b"].contiguous())


class StaticSubnet:
    """A concrete (non-elastic) SR net sliced out of an OFAMobileNetS4, or
    out of an OFAMobileNetX4: its decoder (`mode="sr"`, on the decoder
    trunk) or its encoder and decoder (`mode="autoencoder"`, on an HR
    input).

    `fold_tail` (with folded BN) runs the output conv before the last
    pixel shuffle, and in autoencoder mode each unshuffle conv after its
    unshuffle, as convs with folded weights at the lower resolution (exact,
    see `_fold_conv_through_shuffle`). On an S4 net the shuffle-tail kernel
    consumes that tail, so the kernels turn the fold off (the JAX package's
    rule). The tail kernel is 5x5 only, in both packages, and the X4's
    shuffle convs are 3x3: they run conv2d + pixel_shuffle, so on an X4 net
    `fold_tail` depends on `fold_bn` and `pixel_d` alone, and the kernels
    reach its MBConv blocks only."""

    def __init__(self, net, cfg: SubnetConfig, *, fold_bn: bool = True,
                 mode: str = "sr", use_kernels: Optional[bool] = None,
                 fold_tail: bool = True):
        if mode not in ("sr", "autoencoder"):
            raise ValueError("mode must be 'sr' or 'autoencoder', got %r" % (mode,))
        if mode == "autoencoder" and net.n_trunks != 2:
            raise ValueError("mode='autoencoder' needs an OFAMobileNetX4 (an encoder)")
        sp = self.space = net.space
        check_n_trunks(sp, cfg, net.n_trunks)
        self.cfg = cfg
        self.pixel_d = cfg.pixel_d
        self.fold_bn = fold_bn
        self.mode = mode
        self.eps = net.dec_first_conv_block.bn.eps
        self.device = net.device
        # the kernels take folded BN (the JAX package's `use_pallas and
        # fold_bn`)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and fold_bn
        elif use_kernels and not fold_bn:
            raise ValueError("use_kernels=True needs fold_bn=True: the fused "
                             "kernels take BN-folded weights")
        self.use_kernels = use_kernels
        self.tail_kernel = use_kernels and net.CONV_KS == SHUFFLE_TAIL_KS
        self.fold_tail = (fold_tail and fold_bn and self.pixel_d >= 1
                          and not self.tail_kernel)

        fb = dict(fold_bn=fold_bn, eps=self.eps)
        m = {}
        with torch.no_grad():
            if mode == "autoencoder":
                m["enc_unshuffle"] = [_channels_last(_materialize_conv_layer(layer, **fb))
                                      for layer in net.unshuffle_blocks[:self.pixel_d]]
                m["enc_stages"] = self._trunk(net.enc_blocks, 0, fb)
                m["enc_final"] = [_channels_last(_materialize_conv_layer(layer, **fb))
                                  for layer in net.enc_final_conv_blocks]
                if self.fold_tail:
                    # unshuffle(conv(x, w)) == conv(unshuffle(x), W'): the
                    # decoder fold on z = unshuffle(x), unshuffled on both
                    # sides
                    m["enc_unshuffle_folded"] = [
                        _channels_last(dict(zip(("w", "b"), _fold_conv_through_shuffle(
                            lp["w"], lp["b"])))) for lp in m["enc_unshuffle"]]
            m["dec_first"] = _materialize_conv_layer(net.dec_first_conv_block, **fb)
            m["dec_stages"] = self._trunk(net.dec_blocks, net.n_trunks - 1, fb)
            m["dec_final"] = [_channels_last(_materialize_conv_layer(layer, **fb))
                              for layer in net.dec_final_conv_blocks]
            shuffle = []
            for layer in net.shuffle_blocks[:self.pixel_d]:
                lp = _materialize_conv_layer(layer, **fb)
                if self.tail_kernel:
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
                # conv with 4x the channels at LR: exact, see
                # _fold_conv_through_shuffle
                wf, bf = _fold_conv_through_shuffle(m["dec_out"]["w"],
                                                    m["dec_out"]["b"])
                m["dec_out_folded"] = _channels_last({"w": wf, "b": bf})
        self.params = m

    def _trunk(self, blocks, trunk, fb):
        """Trunk `trunk`'s active MBConv blocks by stage, sliced (and, with
        the kernels, as the MBConv kernel's operands)."""
        sp, cfg = self.space, self.cfg
        base_b, base_s = trunk * sp.blocks_per_trunk, trunk * sp.n_stages
        stages = []
        for stage in range(sp.n_stages):
            active = []
            for i in range(cfg.d[base_s + stage]):
                bi = stage * sp.max_depth + i
                bp = _materialize_mbconv(blocks[bi].mobile_inverted_conv, sp,
                                         cfg.ks[base_b + bi], cfg.e[base_b + bi], **fb)
                if self.use_kernels:
                    bp = {"ks": bp["ks"], "mid": bp["mid"], "kernel": _kernel_mbconv_args(bp)}
                else:
                    bp.update({k: _channels_last(bp[k]) for k in ("ib", "dw", "pl")})
                active.append(bp)
            stages.append(active)
        return stages

    # -- forward ---------------------------------------------------------------

    def _post(self, lp, y, act=None):
        if self.fold_bn:
            y = y + lp["b"]
        else:
            bn = lp["bn"]
            y = batch_norm(y, bn["scale"], bn["bias"], bn["mean"], bn["var"],
                           eps=self.eps)
        return apply_act(y, act)

    def _conv_layer(self, lp, x, *, shuffle=None, row_valid=None, f=1):
        x = _row_mask(x, row_valid, f)
        return shuffle_slot(self._post(lp, conv2d(x, lp["w"])), shuffle)

    def _mbconv(self, bp, x, row_valid=None):
        """One MBConv block with its identity shortcut; the rows outside
        `row_valid` are zeroed in its mid activation, before the depthwise
        (the only spatial conv of the block)."""
        if "kernel" in bp:
            return fused_mbconv_infer(x, *bp["kernel"], residual=True, row_valid=row_valid)
        y = self._post(bp["ib"], conv2d(x, bp["ib"]["w"]), act="relu6")
        y = _row_mask(y, row_valid)
        y = self._post(bp["dw"], depthwise_conv2d(y, bp["dw"]["w"]), act="relu6")
        y = self._post(bp["pl"], conv2d(y, bp["pl"]["w"]))
        return y + x

    def _encode(self, x, rv):
        """The encoder on the HR frame; `rv` the valid rows in LR
        (bottleneck) units, so that at the HR input the factor is
        2**pixel_d, halved by each unshuffle."""
        m = self.params
        f = 2 ** self.pixel_d
        for ei, lp in enumerate(m["enc_unshuffle"]):
            if self.fold_tail:
                fold = m["enc_unshuffle_folded"][ei]
                x = conv2d(pixel_unshuffle(_row_mask(x, rv, f), 2), fold["w"]) + fold["b"]
            else:
                x = self._conv_layer(lp, x, shuffle="unshuffle", row_valid=rv, f=f)
            f //= 2
        skip = x
        for stage in m["enc_stages"]:
            for bp in stage:
                x = self._mbconv(bp, x, rv)
        for i, lp in enumerate(m["enc_final"]):
            x = self._conv_layer(lp, x, row_valid=rv)
            if i == 0:
                x = x + skip
        return x

    def _lr_rows(self, row_valid):
        """`row_valid` as (lo, hi) ints at the decoder's LR input: as given
        in sr mode; in autoencoder mode the HR rows divided by 2**pixel_d,
        which must divide them (the ModCrop contract: the valid region's
        pixel-unshuffle grid is then the unpadded frame's)."""
        if row_valid is None:
            return None
        lo, hi = (int(v) for v in row_valid)
        if self.mode != "autoencoder":
            return lo, hi
        sc = 2 ** self.pixel_d
        if lo % sc or hi % sc:
            raise ValueError("autoencoder row_valid must be multiples of 2**pixel_d = %d "
                             "(the pixel-unshuffle grid); got (%d, %d)" % (sc, lo, hi))
        return lo // sc, hi // sc

    def __call__(self, x, row_valid=None):
        """x: the LR frame(s) (`mode="sr"`) or the HR frame(s)
        (`mode="autoencoder"`), NHWC float32 on the subnet's device.

        `row_valid`: (lo, hi), the input rows that are the frame's; the
        others are re-zeroed before every spatial conv, so the valid rows of
        the output equal the unpadded frame's. In autoencoder mode lo and
        hi are HR rows and multiples of 2**pixel_d."""
        m = self.params
        rv = self._lr_rows(row_valid)
        if self.mode == "autoencoder":
            x = self._encode(x, rv)
        x = self._conv_layer(m["dec_first"], x, row_valid=rv)
        skip = x
        for stage in m["dec_stages"]:
            for bp in stage:
                x = self._mbconv(bp, x, rv)
        for i, lp in enumerate(m["dec_final"]):
            x = self._conv_layer(lp, x, row_valid=rv)
            if i == 0:
                x = x + skip
        f = 1
        for li, lp in enumerate(m["shuffle"]):
            if self.fold_tail and li == len(m["shuffle"]) - 1:
                # keep the last shuffle conv's output at LR (256 ch): the
                # folded output conv consumes the pre-shuffle layout
                x = self._conv_layer(lp, x, row_valid=rv, f=f)
                fold = m["dec_out_folded"]
                return pixel_shuffle(conv2d(_row_mask(x, rv, f), fold["w"]) + fold["b"], 2)
            if self.tail_kernel:
                x = fused_shuffle_tail(_row_mask(x, rv, f), lp["w_hwio"], lp["b"])
            else:
                x = self._conv_layer(lp, x, shuffle="shuffle", row_valid=rv, f=f)
            f *= 2
        return self._conv_layer(m["dec_out"], x, row_valid=rv, f=f)


def get_active_subnet(net, cfg: SubnetConfig, *, fold_bn: bool = True,
                      mode: str = "sr", use_kernels: Optional[bool] = None,
                      fold_tail: bool = True) -> StaticSubnet:
    return StaticSubnet(net, cfg, fold_bn=fold_bn, mode=mode,
                        use_kernels=use_kernels, fold_tail=fold_tail)
