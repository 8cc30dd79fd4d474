"""The frozen MAC counts and the rooflines' byte and operation counts,
against counts made by hand."""

import pytest

from portbench import flops, harness, roofline

S4 = harness.load_json(harness.BENCH_DIR + "/configs/ofa_s4.json")
MBV3 = harness.load_json(harness.BENCH_DIR + "/configs/ofa_mbv3.json")


def uniform(ks, e, d, pd, blocks=16, stages=4):
    return {"ks": [ks] * blocks, "e": [e] * blocks, "d": [d] * stages, "pixel_d": pd}


def test_720p_frame_macs_by_hand():
    px = 180 * 320
    block = px * 64 * 384 + px * 384 * 49 + px * 384 * 64
    hand = (px * 3 * 64 * 25 + 8 * block + 2 * px * 64 * 64 * 25 + px * 64 * 256 * 25
            + 4 * px * 64 * 256 * 25 + 16 * px * 64 * 3 * 25)
    assert hand == 165_781_094_400
    assert flops.s4_subnet_macs(S4, uniform(7, 6, 2, 2), 720, 1280) == hand


def test_kernel_phase_macs_by_hand():
    px = 24 * 24
    block = px * 64 * 384 + px * 384 * 25 + px * 384 * 64
    hand = (px * 3 * 64 * 25 + 16 * block + 2 * px * 64 * 64 * 25 + px * 64 * 256 * 25
            + 4 * px * 64 * 256 * 25 + 16 * px * 64 * 3 * 25)
    assert hand == 1_886_072_832
    assert flops.s4_subnet_macs(S4, uniform(5, 6, 4, 2), 96, 96) == hand
    # the phase's draw of ks 3/5/7 a block averages 1.90 G an image
    mean = sum(flops.s4_subnet_macs(S4, uniform(k, 6, 4, 2), 96, 96) for k in (3, 5, 7)) / 3
    assert round(mean / 1e9, 2) == 1.90


def test_mbv3_max_subnet_macs_by_hand():
    """OFA-MobileNetV3's ks7/e6/d4 subnet at 224 px, layer by layer."""
    f = 112 * 112 * 3 * 16 * 9 + 112 * 112 * 16 * 9 + 112 * 112 * 16 * 16
    hw, cin = 112, 16
    for width, stride, _, se, n in MBV3["stages"]:
        for i in range(n):
            mid = cin * 6
            f += hw * hw * cin * mid
            hw2 = hw // (stride if i == 0 else 1)
            f += hw2 * hw2 * mid * 49
            if se:
                f += mid * flops.make_divisible(mid // 4, 8) * 2
            f += hw2 * hw2 * mid * width
            hw, cin = hw2, width
    f += 7 * 7 * 160 * 960 + 960 * 1280 + 1280 * 1000
    a = {"ks": [7] * 20, "e": [6] * 20, "d": [4] * 5}
    assert flops.cls_subnet_macs(MBV3, a, 224) == f


def test_bn_bytes_by_hand():
    fwd, bwd = roofline.bn_train(9216, 384, 2)
    assert fwd.bytes == 2 * 9216 * 384 * 2 + 6 * 384 * 4 == 14_164_992
    assert bwd.bytes == 3 * 9216 * 384 * 2 + 5 * 384 * 4 == 21_241_344
    assert fwd.least_s() == pytest.approx(14_164_992 / 3.35e12)


def test_dw_masked_bytes_by_hand():
    fwd, dgrad, wgrad = roofline.dw_masked_train(9216, 9216, 384, 5, 2)
    hand = 9216 * 384 * 2 + 25 * 384 * 2 + 9216 * 384 * 2
    assert fwd.bytes == dgrad.bytes == wgrad.bytes == hand == 14_174_976


def test_pw_masked_bytes_and_operations_by_hand():
    calls = roofline.pw_masked_train(9216, 64, 384, 2)
    assert len(calls) == 6
    hand = 9216 * 64 * 2 + 64 * 384 * 2 + 9216 * 384 * 2
    assert all(c.bytes == hand == 8_306_688 for c in calls)
    assert all(c.tensor_ops == 2 * 9216 * 64 * 384 for c in calls)
    assert calls[0].least_s() == pytest.approx(hand / 3.35e12)  # bytes bound it


def test_mbconv_and_tail_by_hand():
    calls = roofline.s4_serve_calls(S4, uniform(7, 6, 2, 2), 180, 320)
    mb = [c for c in calls if c.family == "mbconv"]
    tail = [c for c in calls if c.family == "shuffle_tail"]
    assert len(mb) == 8 and len(tail) == 2
    px = 180 * 320
    assert mb[0].bytes == 2 * px * 64 * 4 + (64 * 384 + 49 * 384 + 384 * 64 + 2 * 384 + 64) * 4
    assert mb[0].least_s() == pytest.approx(3 * 2 * px * 64 * 384 * 2 / 495e12)
    assert tail[0].tensor_ops == 3 * 2 * px * 64 * 256 * 25
    assert tail[1].tensor_ops == 4 * tail[0].tensor_ops
    assert sum(c.least_s() for c in tail) == pytest.approx(1.430e-3, rel=2e-3)


def test_s4_step_calls_count_every_bn():
    sub = uniform(5, 6, 4, 2)
    calls = roofline.s4_train_calls(S4, sub, 16, 96, 2)
    n_bn = 3 * 16 + 2 + 4
    assert sum(c.family == "bn" for c in calls) == 2 * n_bn
    assert sum(c.family == "dw_masked" for c in calls) == 3 * 16
    assert sum(c.family == "pw_masked" for c in calls) == 6 * 16


def test_cls_step_calls_skip_gated_blocks():
    a = {"ks": [3] * 20, "e": [3] * 20, "d": [2] * 5}
    calls = roofline.cls_train_calls(MBV3, a, 64, 224, 2)
    assert sum(c.family == "dw_masked" for c in calls) == 3 * 10
    assert sum(c.family == "bn" for c in calls) == 2 * (3 + 3 * 10 + 1)
