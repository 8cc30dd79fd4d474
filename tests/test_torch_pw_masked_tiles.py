"""The masked 1x1 kernel's host-side launch plan, on the CPU.

csrc/pw_masked.cu runs only on the card; these tests hold what its wrapper
(`ofa_sr_tpu_torch/ops/kernels/pw_masked.py`) computes on the host and the
mirrors of the kernel it keeps: the persistent forward / dgrad grid and the
wgrad's partition come from the shapes alone and are the same on every
call; every 64-row tile has one owner (a block's warpgroup, as the kernel
walks them); the wgrad's runs of rows cover every row once, in clusters of
CLUSTER runs, one wave of blocks at most; the wgrad's float32 partials
(where more than one cluster of runs adds them) stay at or under a tenth of
the bf16 operands' bytes at the S4 step's shapes; and the shared memory a
block takes, the resident bank included (float32's held split at M 384),
fits an H100 block.
"""

import numpy as np
import pytest
import torch

from ofa_sr_tpu_torch.ops.kernels import pw_masked as pw

DTYPES = (torch.float32, torch.bfloat16)
# the S4 step's rows (bs16 at LR 48 and 24), phase 2's edges (fewer rows
# than a tile, a ragged tile) and larger ones
ROWS = (1, 40, 63, 64, 1000, 9216, 36864, 147456)
# the wgrad's [P, Q]: the S4 expand's (M 384, Cin 64) and phase 2's edge (M
# 72, Cout 40)
PQ = ((384, 64), (72, 40))
S4_ROWS, S4_MIDS = (36864, 9216), (192, 256, 384)


def _ids(dtype):
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("bound_k", (False, True), ids=("bound_n", "bound_k"))
@pytest.mark.parametrize("rows", ROWS)
def test_every_row_tile_has_one_owner(rows, bound_k, dtype):
    """gemm_grid's blocks walk the 64-row tiles as the kernel does (block b
    takes tiles b, b + blocks, ..., its j-th to warpgroup j % wgs): every
    tile once, no warpgroup more than the plan's count, at most
    GEMM_BLOCKS blocks, none without a tile."""
    blocks, per = pw.gemm_grid(rows, dtype, bound_k)
    wgs = pw.GEMM_CFG[dtype, bound_k]["wgs"]
    tiles = -(-rows // pw.BM)
    assert 1 <= blocks <= pw.GEMM_BLOCKS and blocks <= tiles
    seen = np.zeros(tiles, np.int32)
    walked = {}
    for b in range(blocks):
        for w in range(wgs):
            for j in range(w, tiles, wgs):
                t = b + j * blocks
                if t >= tiles:
                    break
                seen[t] += 1
                walked[b, w] = walked.get((b, w), 0) + 1
                assert pw.tile_owner(t, blocks, wgs) == (b, w)
    assert (seen == 1).all()
    assert max(walked.values()) == per
    assert {b for b, _ in walked} == set(range(blocks))


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("pq", PQ, ids=("384x64", "72x40"))
@pytest.mark.parametrize("rows", ROWS)
def test_wgrad_runs_cover_every_row_once(rows, pq, dtype):
    """The wgrad's CLUSTER * G runs of a multiple of BM rows (block z sums
    rows [z * per, min(rows, (z + 1) * per))) cover every row once, the
    last runs possibly empty but no run past what the rows need; the
    blocks over the 64 x 64 tiles are one wave (WGRAD_BLOCKS) unless one
    cluster of runs already exceeds it."""
    p, q = pq
    per, g = pw.wgrad_partition(rows, p, q, dtype)
    runs = pw.CLUSTER * g
    assert g >= 1 and per >= pw.BM and per % pw.BM == 0
    assert runs * per >= rows and (per - pw.BM) * runs < rows
    cover = np.zeros(rows, np.int32)
    for z in range(runs):
        cover[min(rows, z * per):min(rows, (z + 1) * per)] += 1
    assert (cover == 1).all()
    tiles = -(-p // pw.BM) * -(-q // pw.BN)
    assert g == 1 or runs * tiles <= pw.WGRAD_BLOCKS


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("mid", S4_MIDS)
@pytest.mark.parametrize("rows", S4_ROWS)
def test_wgrad_partials_stay_under_a_tenth(rows, mid, dtype):
    """At the S4 step's shapes (P 384, Q 64, the sampled mid), the float32
    partials of G > 1 clusters (each written once and read back once, the
    live 64-row P tiles) are at most PARTIAL_SHARE of the operands' bytes
    (the live rows of A and all of B, read once, in bf16: the smaller)."""
    p, q = 384, 64
    _, g = pw.wgrad_partition(rows, p, q, dtype)
    live_p = -(-mid // pw.BM) * pw.BM
    partials = 0 if g == 1 else 2 * g * live_p * q * 4
    operands = rows * (mid + q) * 2
    assert partials <= pw.PARTIAL_SHARE * operands


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
def test_plans_come_from_the_shapes_alone(dtype, monkeypatch):
    """The plans read nothing of the card (its queries raise here) and give
    the same numbers on every call."""
    def refuse(*a, **k):
        raise AssertionError("the launch plan queried the device")

    for name in ("get_device_properties", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for rows in ROWS:
        for bound_k in (False, True):
            assert pw.gemm_grid(rows, dtype, bound_k) == pw.gemm_grid(rows, dtype, bound_k)
        for p, q in PQ:
            assert pw.wgrad_partition(rows, p, q, dtype) == pw.wgrad_partition(rows, p, q, dtype)


# the products' (K, N) of the S4 step and phase 2's edge: expand forward
# (Cin, M) and project dgrad (Cout, M) bounded on N; project forward (M,
# Cout) and expand dgrad (M, Cin) bounded on K
GEMM_SHAPES = {"bound_n": ((64, 384), (24, 72), (40, 72)),
               "bound_k": ((384, 64), (72, 40), (72, 24))}


@pytest.mark.parametrize("dtype", DTYPES, ids=_ids)
@pytest.mark.parametrize("direction", ("bound_n", "bound_k", "wgrad"))
def test_shared_memory_fits_the_card(direction, dtype):
    """Each form's and type's dynamic shared memory (smem_bytes, the
    kernel's sizes; chip_smoke.py phase 1 holds them to the kernel's own)
    fits an H100 block, the resident bank at M 384 included: float32's held
    split into big and small halves beside a ring; the wrapper takes these
    shapes (gemm_supported) and refuses a bank that cannot fit."""
    if direction == "wgrad":
        assert pw.smem_bytes("wgrad", dtype) <= pw.SMEM_MAX
        return
    bound_k = direction == "bound_k"
    for k, n in GEMM_SHAPES[direction]:
        assert pw.smem_bytes(direction, dtype, k, n) <= pw.SMEM_MAX
        assert pw.gemm_supported(k, n, dtype, bound_k)
    k, n = GEMM_SHAPES[direction][0]
    big = dict(bound_n=(k, 4 * n), bound_k=(4 * k, n))[direction]
    assert not pw.gemm_supported(*big, dtype, bound_k)
