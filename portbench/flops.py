"""Multiply-accumulates (MACs) of a subnet's forward: a frozen copy of the
port's closed forms (`s4_subnet_flops`, `cls_subnet_flops` in
ofa_sr_tpu_torch/search/flops.py), taking the sizes from a configuration
file in place of a net, so that a later change to the program cannot move
the benchmark's yardstick. The reference calls the field 'flops'; these
are MACs, and a step's operations are 2 a MAC forward and 4 backward.
"""

from __future__ import annotations


def make_divisible(v, divisor, min_val=None):
    """`v` rounded to the nearest multiple of `divisor`, never below 90% of
    it: the published middle widths, make_divisible(round(in * e), 8)."""
    if min_val is None:
        min_val = divisor
    new_v = max(min_val, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def conv_macs(h, w, cin, cout, k, groups=1):
    return h * w * (cin // groups) * cout * k * k


def s4_subnet_macs(cfg, subnet, hr_h, hr_w):
    """MACs of one forward of an S4 subnet ({"ks", "e", "d", "pixel_d"},
    one ks and e a block, one d a stage) at an HR output of hr_h x hr_w
    (input hr / 2^pixel_d)."""
    w, ck = cfg["width"], cfg["conv_ks"]
    md = max(cfg["depth_list"])
    lh, lw = hr_h // 2 ** subnet["pixel_d"], hr_w // 2 ** subnet["pixel_d"]
    f = conv_macs(lh, lw, 3, w, ck)
    for s in range(cfg["n_stages"]):
        for i in range(subnet["d"][s]):
            bi = s * md + i
            mid = make_divisible(round(w * subnet["e"][bi]), 8)
            k = subnet["ks"][bi]
            f += conv_macs(lh, lw, w, mid, 1)
            f += conv_macs(lh, lw, mid, mid, k, groups=mid)
            f += conv_macs(lh, lw, mid, w, 1)
    f += 2 * conv_macs(lh, lw, w, w, ck)
    hh, ww = lh, lw
    for _ in range(subnet["pixel_d"]):
        f += conv_macs(hh, ww, w, 4 * w, ck)
        hh *= 2
        ww *= 2
    f += conv_macs(hh, ww, w, 3, ck)
    return f


def cls_subnet_macs(cfg, arch, image_size):
    """MACs of a classification subnet ({"ks", "e", "d"}) at its widest
    width, as the forward runs it: the first conv and block, each block its
    stage's depth reaches (the first of a stage always), its SE, the head."""
    hw = image_size // 2
    fw = cfg["first_conv_width"]
    fbo = cfg.get("first_block_width") or fw
    f = conv_macs(hw, hw, 3, fw, 3)
    f += conv_macs(hw, hw, fw, fw, 3, groups=fw)
    f += conv_macs(hw, hw, fw, fbo, 1)
    in_ch, bi = fbo, 0
    for si, (width, stride, _, se, n_block) in enumerate(cfg["stages"]):
        for i in range(n_block):
            st = stride if i == 0 else 1
            if i < arch["d"][si] or i == 0:
                mid = make_divisible(round(in_ch * arch["e"][bi]), 8)
                k = arch["ks"][bi]
                f += conv_macs(hw, hw, in_ch, mid, 1)
                hw2 = hw // st
                f += conv_macs(hw2, hw2, mid, mid, k, groups=mid)
                if se:
                    f += mid * make_divisible(mid // 4, 8) * 2
                f += conv_macs(hw2, hw2, mid, width, 1)
            if i == 0:
                hw //= st
            in_ch = width
            bi += 1
    if cfg.get("final_expand_width"):
        f += conv_macs(hw, hw, in_ch, cfg["final_expand_width"], 1)
        f += cfg["final_expand_width"] * cfg["feature_mix_width"]
    else:
        f += conv_macs(hw, hw, in_ch, cfg["feature_mix_width"], 1)
    f += cfg["feature_mix_width"] * cfg["n_classes"]
    return f
