"""Overlap-tiled large-frame inference: counterpart of
ofa_sr_tpu/train/tiled_infer.py.

The frame is cut into fixed-size tiles with a halo of `halo` pixels of
real neighbour context on every interior side; each window runs through
the materialized subnet and the output centres are stitched.

Exactness: an output pixel depends on the inputs within the network's
receptive field. With halo >= that radius (`receptive_field_radius`) the
interior of every tile is window-exact against the full-frame execution,
and at the true frame border a window sees the same zero padding (SAME
convs) the full frame does: windows are clamped inside the frame, never
zero-padded, so every window has the one shape (tile + 2*halo).

`tiled_sr_infer_mesh` splits the frame's window batch over the ranks of a
mesh: each rank runs its share and the results are gathered (an
all-reduce of a zero-filled buffer), then stitched on every rank in the
same order as `tiled_sr_infer`, so the two give the same frame.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_sum, make_mesh


def receptive_field_radius(cfg, space, conv_ks: int = 5) -> int:
    """Receptive-field radius (in LR pixels before the shuffle head) of a
    decoder subnet: first conv + per-block depthwise + two final convs, plus
    the shuffle head's convs mapped back to LR resolution."""
    r = conv_ks // 2                      # dec_first_conv
    n_stages = space.n_stages
    d = cfg.d[-n_stages:] if len(cfg.d) > n_stages else cfg.d
    ks = cfg.ks[-space.blocks_per_trunk:] if len(cfg.ks) > space.blocks_per_trunk else cfg.ks
    bi = 0
    for stage in range(n_stages):
        for i in range(space.max_depth):
            if i < min(d[stage], space.max_depth):
                r += ks[bi] // 2          # depthwise
            bi += 1
    r += 2 * (conv_ks // 2)               # two dec_final convs
    # shuffle head: conv at LR, then conv at 2x (halves back to LR), ...
    scale = 1
    for _ in range(cfg.pixel_d):
        r += (conv_ks // 2 + scale - 1) // scale
        scale *= 2
    r += (conv_ks // 2 + scale - 1) // scale  # output conv at HR
    return r


def receptive_field_radius_autoencoder(cfg, space, conv_ks: int = 5) -> int:
    """Receptive-field radius in HR-input pixels of an X4 autoencoder subnet
    (encoder unshuffle chain + encoder trunk + decoder), a multiple of
    2**pixel_d so that halos keep the pixel-unshuffle grid.

    Conservative: every encoder conv is counted at its full k//2 LR pixels
    even where it runs above LR resolution."""
    sc = 2 ** cfg.pixel_d
    r = cfg.pixel_d * (conv_ks // 2)          # enc_unshuffle convs
    d = cfg.d[:space.n_stages]
    ks = cfg.ks[:space.blocks_per_trunk]
    bi = 0
    for stage in range(space.n_stages):
        for i in range(space.max_depth):
            if i < min(d[stage], space.max_depth):
                r += ks[bi] // 2              # encoder depthwise
            bi += 1
    r += 3 * (conv_ks // 2)                   # enc_final convs
    r += receptive_field_radius(cfg, space, conv_ks)  # decoder side
    return r * sc  # LR-unit radius -> HR pixels


def _positions(extent, t):
    """Output-tile start positions covering [0, extent): stride t, with the
    last tile flush against the end (the overlap recomputes pixels)."""
    pos = list(range(0, max(extent - t, 0) + 1, t))
    if pos[-1] != extent - t:
        pos.append(extent - t)
    return pos


def _windows(x, tile, halo):
    """The clamped overlap windows of a (1, h, w, C) frame: (windows
    [N, win, win, C], placements [(ti, tj, off_i, off_j)])."""
    _, h, w, _ = x.shape
    win = tile + 2 * halo
    wins, place = [], []
    for ti in _positions(h, tile):
        src_i = min(max(ti - halo, 0), h - win)
        for tj in _positions(w, tile):
            src_j = min(max(tj - halo, 0), w - win)
            wins.append(x[0, src_i:src_i + win, src_j:src_j + win])
            place.append((ti, tj, ti - src_i, tj - src_j))
    return torch.stack(wins), place


def _stitch(out, res, placement, tile, scale):
    ti, tj, off_i, off_j = placement
    out[0, ti * scale:(ti + tile) * scale, tj * scale:(tj + tile) * scale] = res[
        off_i * scale:(off_i + tile) * scale, off_j * scale:(off_j + tile) * scale]


def tiled_sr_infer(subnet_fn, x, *, tile: int, halo: int, scale: int):
    """Run `subnet_fn` ((1, h, w, C) -> (1, h*scale, w*scale, C)) over
    overlapping windows of the frame `x` and stitch their centres. A frame
    smaller than a window runs whole."""
    _, h, w, c = x.shape
    if x.shape[0] != 1:
        raise ValueError("frame-at-a-time inference: x must be (1, H, W, C)")
    win = tile + 2 * halo
    if h < win or w < win:
        return subnet_fn(x)
    out = None
    for ti in _positions(h, tile):
        src_i = min(max(ti - halo, 0), h - win)
        for tj in _positions(w, tile):
            src_j = min(max(tj - halo, 0), w - win)
            res = subnet_fn(x[:, src_i:src_i + win, src_j:src_j + win].contiguous())
            if out is None:
                out = res.new_zeros((1, h * scale, w * scale, res.shape[-1]))
            _stitch(out, res[0], (ti, tj, ti - src_i, tj - src_j), tile, scale)
    return out


def tiled_sr_infer_mesh(subnet_fn, x, *, tile: int, halo: int, scale: int, mesh=None,
                        windows_per_device: int = 1):
    """`tiled_sr_infer` with the frame's windows split over the ranks of
    `mesh` (by default this process alone): the window batch is taken in
    chunks of world * windows_per_device, the last chunk padded with copies
    of its last window as the JAX package pads it, rank r runs windows
    [r*k, (r+1)*k) of each chunk as one batch through `subnet_fn`, and the
    chunk's results reach every rank through an all-reduce; every rank
    stitches the whole frame. `subnet_fn` takes a batch (k, win, win, C)."""
    _, h, w, c = x.shape
    if x.shape[0] != 1:
        raise ValueError("frame-at-a-time inference: x must be (1, H, W, C)")
    win = tile + 2 * halo
    if h < win or w < win:
        return subnet_fn(x)
    if mesh is None:
        mesh = make_mesh(x.device)
    k = windows_per_device
    chunk = mesh.world * k
    wins, place = _windows(x, tile, halo)
    n = wins.shape[0]
    out = None
    for start in range(0, n, chunk):
        part = wins[start:start + chunk]
        if part.shape[0] < chunk:  # the last chunk: padded to the one batch shape
            part = torch.cat([part, part[-1:].expand(chunk - part.shape[0], -1, -1, -1)])
        res = subnet_fn(part[mesh.rank * k:(mesh.rank + 1) * k].contiguous())
        gathered = res.new_zeros((chunk,) + tuple(res.shape[1:]))
        gathered[mesh.rank * k:(mesh.rank + 1) * k] = res
        all_reduce_sum(gathered, mesh.group)
        if out is None:
            out = res.new_zeros((1, h * scale, w * scale, res.shape[-1]))
        for i in range(min(chunk, n - start)):
            _stitch(out, gathered[i], place[start + i], tile, scale)
    return out
