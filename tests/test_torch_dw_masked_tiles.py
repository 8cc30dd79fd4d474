"""The masked depthwise kernel's host-side tiling and index math, on the CPU.

csrc/dw_masked.cu runs only on the card; these tests hold what its wrapper
(`ofa_sr_tpu_torch/ops/kernels/dw_masked.py`) computes on the host and
mirrors of the kernel: the output tiles and the strips each warp takes
cover every output (forward, stride-1 dgrad, wgrad) and every dx pixel of
the stride-2 dgrad's parity classes exactly once; each launch's blocks walk
runs of tiles that cover every tile exactly once, from the shapes alone
(the wgrad's with a bounded workspace); the shared memory a block takes
fits the card; and the stride-2 dgrad's parity decomposition (four dense
sub-correlations of dy, `parity_taps`) gives the plain version's dx.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ofa_sr_tpu_torch.ops.kernels import dw_masked as dw

# phase 2's shapes (chip_smoke.py `dw_masked_cases`): the S4 step's (bs16,
# LR 48 and 24, C 384), MBV3's (batch 64: C 96 at 112x112 at stride 1 and
# 2, C 960 at 7x7), and ragged and odd ones
SHAPES = [((16, 48, 48, 384), 1), ((16, 24, 24, 384), 1), ((64, 112, 112, 96), 1),
          ((64, 112, 112, 96), 2), ((64, 7, 7, 960), 1), ((8, 20, 36, 100), 1),
          ((8, 15, 15, 100), 2), ((4, 13, 21, 37), 1), ((4, 15, 45, 37), 2),
          ((3, 1, 1, 5), 1), ((2, 2, 3, 8), 2)]
DTYPES = (torch.float32, torch.bfloat16)


def _ids(cases):
    return ["%s-s%d" % ("x".join(map(str, s)), st) for s, st in cases]


def tile_grid(n, rows, cols, tile_rows, tile_cols=dw.TILE_W):
    """(image, first row, first column) of each tile over an [n, rows,
    cols] grid, in the order the kernel's blocks walk them (TileAt)."""
    th, tw = -(-rows // tile_rows), -(-cols // tile_cols)
    return [(t // tw // th, t // tw % th * tile_rows, t % tw * tile_cols)
            for t in range(n * th * tw)]


def warp_strips(tile_rows, strip_rows):
    """{warp: [(first row, first column) of each strip it takes]} in a tile
    of the forward, stride-1 dgrad or wgrad, as the kernel assigns them:
    warp w takes strips w, w + WARPS, ..., each strip_rows x STRIP
    outputs."""
    per_row = dw.TILE_W // dw.STRIP
    n = tile_rows // strip_rows * per_row
    return {w: [(q // per_row * strip_rows, q % per_row * dw.STRIP)
                for q in range(w, n, dw.WARPS)] for w in range(dw.WARPS)}


def strip_cover(n, rows, cols, tile_rows, strip_rows):
    """How often each output of [n, rows, cols] is computed by the tiles of
    `tile_rows` rows and the strips of `strip_rows` rows their warps take (a
    strip starting past the output's edge is skipped, its outputs past the
    edge are not stored), as csrc/dw_masked.cu's forward, stride-1 dgrad
    and wgrad do."""
    count = np.zeros((n, rows, cols), np.int32)
    strips = [s for ss in warp_strips(tile_rows, strip_rows).values() for s in ss]
    for img, o0, p0 in tile_grid(n, rows, cols, tile_rows):
        for r, s0 in strips:
            o, p = o0 + r, p0 + s0
            if o < rows and p < cols:
                count[img, o:o + strip_rows, p:p + dw.STRIP] += 1
    return count


@pytest.mark.parametrize("shape,stride", SHAPES, ids=_ids(SHAPES))
def test_tiles_cover_every_output_once(shape, stride):
    n, h, w, _ = shape
    ho, wo = dw.out_size(h, 7, stride), dw.out_size(w, 7, stride)
    # the warps take every strip of a tile once between them
    for rows, strip_rows in {dw.CORR_ROWS[stride], dw.WGRAD_ROWS[stride]}:
        strips = [s for ss in warp_strips(rows, strip_rows).values() for s in ss]
        assert sorted(strips) == [(r, c) for r in range(0, rows, strip_rows)
                                  for c in range(0, dw.TILE_W, dw.STRIP)]
        assert all(len(ss) >= 1 for ss in warp_strips(rows, strip_rows).values())
    for direction, strip_rows in (("fwd", dw.CORR_ROWS[stride][1]),
                                  ("wgrad", dw.WGRAD_ROWS[stride][1])):
        images, rows, cols, tile_rows, _ = dw.launch_grid(direction, n, h, w, stride)
        assert (images, rows, cols) == (n, ho, wo)
        assert (strip_cover(n, ho, wo, tile_rows, strip_rows) == 1).all()
    grid = dw.launch_grid("dgrad", n, h, w, stride)
    assert grid[:3] == (n, h, w)
    if stride == 1:
        assert (strip_cover(n, h, w, grid[3], dw.CORR_ROWS[1][1]) == 1).all()
        return
    # the stride-2 dgrad: each dx tile's four parity classes, DX_CLASS
    # pixels each, one warp a class, strips of one class row x STRIP class
    # columns
    da, db = dw.DX_CLASS
    assert grid[3:] == (2 * da, 2 * db)
    count = np.zeros((n, h, w), np.int32)
    for img, r0, c0 in tile_grid(*grid):
        for ph in (0, 1):
            for pv in (0, 1):
                for r in range(da):
                    for s0 in range(0, db, dw.STRIP):
                        row, col = r0 + 2 * r + ph, c0 + 2 * s0 + pv
                        if row < h and col < w:
                            count[img, row, col:col + 2 * dw.STRIP:2] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape,stride", SHAPES, ids=_ids(SHAPES))
def test_partition_covers_every_tile_once(shape, stride):
    n, h, w, c = shape
    for direction in ("fwd", "dgrad", "wgrad"):
        tiles = len(tile_grid(*dw.launch_grid(direction, n, h, w, stride)))
        for dtype in DTYPES:
            per, g = dw.partition(direction, n, h, w, c, stride, dtype)
            # runs [i*per, (i+1)*per) over the tiles: each tile once, no empty run
            owners = np.zeros(tiles, np.int32)
            for i in range(g):
                owners[i * per:min((i + 1) * per, tiles)] += 1
            assert (owners == 1).all() and (g - 1) * per < tiles
            assert per >= dw.MIN_TILES
            # about CORR_BLOCKS / WGRAD_BLOCKS blocks over the groups: the
            # wgrad's workspace (g * K * K * C floats) is bounded
            groups = -(-c // dw.group_channels(dtype))
            blocks = dw.WGRAD_BLOCKS if direction == "wgrad" else dw.CORR_BLOCKS
            assert g <= -(-blocks // groups)
            assert g * c <= (blocks + groups) * dw.group_channels(dtype)
            # from the shapes alone: the same on every call, whatever ran before
            assert dw.partition(direction, n, h, w, c, stride, dtype) == (per, g)


def test_partition_at_the_s4_step():
    """The S4 step's launches fill the card: at LR 48 between half of and
    all the blocks aimed at, at LR 24 at least a third, each block walking
    at least MIN_TILES tiles."""
    for direction in ("fwd", "dgrad", "wgrad"):
        blocks = dw.WGRAD_BLOCKS if direction == "wgrad" else dw.CORR_BLOCKS
        for dtype in DTYPES:
            groups = 384 // dw.group_channels(dtype)
            for lr, least in ((48, blocks // 2), (24, blocks // 3)):
                per, g = dw.partition(direction, 16, lr, lr, 384, 1, dtype)
                assert least <= g * groups <= blocks
                assert per >= dw.MIN_TILES


@pytest.mark.parametrize("direction", ["fwd", "dgrad", "wgrad"])
def test_shared_memory_fits_the_card(direction):
    """A block's dynamic shared memory fits the H100's 227 KB a block, and
    two blocks, each with its 1 KB reserve, fit an SM's 228 KB."""
    for k in dw.BANK_SIZES:
        for s in dw.STRIDES:
            for dtype in DTYPES:
                b = dw.smem_bytes(direction, k, s, dtype)
                assert 0 < b <= 227 * 1024
                assert 2 * (b + 1024) <= 228 * 1024
                assert b % 16 == 0


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_parity_taps_match_the_gather(k):
    """parity_taps(k, p) lists exactly the taps and dy rows the stride-2
    dgrad gathers for a dx row 2a+p: tap i reaches it from dy row o when
    2o - k//2 + i = 2a+p."""
    for p in (0, 1):
        i0, m, base = dw.parity_taps(k, p)
        for a in range(6):
            h = 2 * a + p
            gather = sorted((i, (h + k // 2 - i) // 2) for i in range(k)
                            if (h + k // 2 - i) % 2 == 0)
            # dy rows a+base .. a+base+m-1 against taps i0+2(m-1) .. i0
            listed = sorted((i0 + 2 * (m - 1 - t), a + base + t) for t in range(m))
            assert gather == listed


def parity_dgrad(dy, w, k, bound, h, wd):
    """dx of the masked depthwise at stride 2 as csrc/dw_masked.cu's
    stride-2 dgrad computes it: per parity class (ph, pv) of dx, a dense
    correlation of dy with the class's sub-grid of the k x k centre taps."""
    n, ho, wo, c = dy.shape
    off = (w.shape[-1] - k) // 2
    dx = torch.zeros(n, h, wd, c, dtype=dy.dtype)
    src = dy.permute(0, 3, 1, 2)
    for ph in (0, 1):
        i0, ni, bi = dw.parity_taps(k, ph)
        rows = len(range(ph, h, 2))
        for pv in (0, 1):
            j0, nj, bj = dw.parity_taps(k, pv)
            cols = len(range(pv, wd, 2))
            if not (ni and nj and rows and cols):
                continue  # k = 1: no tap reaches an odd row or column
            ti = off + i0 + 2 * (ni - 1 - torch.arange(ni))
            tj = off + j0 + 2 * (nj - 1 - torch.arange(nj))
            sub = w[:, :, ti][:, :, :, tj]
            # class pixel (a, b) reads dy[a + bi + t, b + bj + u]: dy zero
            # outside [0, ho) x [0, wo)
            top, left = max(0, -bi), max(0, -bj)
            bottom = max(0, rows + bi + ni - 1 - ho)
            right = max(0, cols + bj + nj - 1 - wo)
            padded = F.pad(src, (left, right, top, bottom))
            window = padded[:, :, bi + top:bi + top + rows + ni - 1,
                            bj + left:bj + left + cols + nj - 1]
            dx[:, ph::2, pv::2, :] = F.conv2d(window, sub, groups=c).permute(0, 2, 3, 1)
    dx[..., bound:] = 0
    return dx


PARITY_SIDES = [(8, 8), (9, 9), (8, 11), (15, 6), (1, 2), (3, 1)]


@pytest.mark.parametrize("h,wd", PARITY_SIDES, ids=["%dx%d" % s for s in PARITY_SIDES])
def test_stride2_dgrad_parity_classes_match_the_plain_dx(h, wd):
    """The four dense sub-correlations give masked_depthwise_grads_reference's
    dx at stride 2 for k 3/5/7 in a 7x7 bank, bounds 0, mid and C, within
    float32 round-off."""
    rng = np.random.default_rng(h * 100 + wd)
    n, c, big = 2, 12, 7
    ho, wo = dw.out_size(h, big, 2), dw.out_size(wd, big, 2)
    x = torch.tensor(rng.standard_normal((n, h, wd, c)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((c, 1, big, big)) * 0.3, dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((n, ho, wo, c)), dtype=torch.float32)
    ks_list = (3, 5, 7)
    for ki, k in enumerate(ks_list):
        for bound in (0, c // 2, c):
            kt = torch.tensor(ki, dtype=torch.int32)
            bt = torch.tensor(bound, dtype=torch.int32)
            ref = dw.masked_depthwise_grads_reference(x, w, kt, bt, dy, ks_list=ks_list,
                                                      stride=2)[0]
            got = parity_dgrad(dy, w, k, bound, h, wd)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
            assert not got[..., bound:].any()
