"""Elastic-kernel transform chain, the masked-execution helpers and the
bucketed-eval spatial mask (counterpart of ofa_sr_tpu/ops/elastic.py).

The sliced forward needs the kernel-transform chain alone: the effective
k x k depthwise kernel is
produced from the max-size bank through learned (k^2 x k^2) matrices applied
largest to smallest, K5 = reshape(vec(center5(K7)) @ M_7to5.T) and so on
(torch F.linear's `v @ M.T`). Depthwise banks are in the torch layout
[C, 1, K, K]; the matmul runs in full float32, so under bf16 compute a
transformed kernel comes back float32 and its caller rounds it to the
bank's type (the JAX package's `kernel_candidates`).

The masked forward (one program for every kernel size and width, the
graphed training step's) runs the depthwise conv at the max kernel size:
`kernel_candidates` stacks every size's effective kernel zero-embedded at
the center of the max window (`embed_center`), `select_kernel` picks one by
a device index with an exact one-hot, and `channel_mask` is the 0/1 mask of
a device width.
"""

from __future__ import annotations

import torch

from ..utils.common import sub_filter_start_end


def transform_matrices_init(ks_list):
    """Identity-initialized transform matrices keyed '%dto%d' like the
    reference parameter names."""
    ks_set = sorted(set(ks_list))
    mats = {}
    for i in range(len(ks_set) - 1):
        small, larger = ks_set[i], ks_set[i + 1]
        mats["%dto%d" % (larger, small)] = torch.eye(small * small)
    return mats


def _center_slice(w, target_ks):
    """Center target_ks x target_ks window of a [C, I, K, K] kernel."""
    start, end = sub_filter_start_end(w.shape[-1], target_ks)
    return w[:, :, start:end, start:end]


def _apply_transform(w, mat):
    """v @ M.T over each channel's row-major flattened (ky, kx) taps."""
    c, i, k, _ = w.shape
    v = w.reshape(c * i, k * k)
    v = torch.matmul(v.float(), mat.float().T)
    return v.reshape(c, i, k, k)


def transform_kernel_chain(weight, matrices, ks_list, target_ks, use_transform=True):
    """The reference get_active_filter: the effective target_ks kernel from
    the max-size bank `weight` [C, 1, K, K]."""
    ks_set = sorted(set(ks_list))
    max_ks = max(ks_set)
    if target_ks == max_ks:
        return weight
    if not use_transform:
        return _center_slice(weight, target_ks)
    w = weight
    for i in range(len(ks_set) - 1, 0, -1):
        src_ks = ks_set[i]
        if src_ks <= target_ks:
            break
        tgt_ks = ks_set[i - 1]
        w = _apply_transform(_center_slice(w, tgt_ks), matrices["%dto%d" % (src_ks, tgt_ks)])
    return w


def embed_center(w, max_ks):
    """Zero-embed a [C, I, k, k] kernel at the center of a max_ks window."""
    k = w.shape[-1]
    if k == max_ks:
        return w
    start, _ = sub_filter_start_end(max_ks, k)
    end = max_ks - k - start
    return torch.nn.functional.pad(w, (start, end, start, end))


def kernel_candidates(weight, matrices, ks_list, use_transform=True):
    """Every candidate effective kernel of the bank `weight` [C, 1, K, K],
    zero-embedded at max size and stacked [n_ks, C, 1, K, K] in ascending
    kernel size. Under bf16 compute the chain runs in float32 against the
    float32 matrices and each candidate is rounded to the bank's type."""
    max_ks = max(ks_list)
    return torch.stack([
        embed_center(transform_kernel_chain(weight, matrices, ks_list, ks, use_transform),
                     max_ks).to(weight.dtype)
        for ks in sorted(set(ks_list))])


def select_kernel(candidates, ks_idx):
    """The candidate at the device index `ks_idx` by a one-hot sum: exact
    (one term is 1 * w, the others 0 * w), and the gradient reaches only the
    selected candidate's transform chain (the others' is exactly 0)."""
    n = candidates.shape[0]
    onehot = (torch.arange(n, device=candidates.device) == ks_idx).to(candidates.dtype)
    return (onehot.view((n,) + (1,) * (candidates.ndim - 1)) * candidates).sum(0)


def channel_mask(active, width, dtype=torch.float32, device=None):
    """(width,) 0/1 mask: 1 for the channels below `active` (an int or a
    device int tensor)."""
    return (torch.arange(width, device=device) < active).to(dtype)


def spatial_valid_mask(valid_h, valid_w, h, w, dtype=torch.float32, device=None):
    """(1, h, w, 1) 0/1 mask: 1 inside the valid top-left (valid_h, valid_w)
    region, 0 in the padding of a frame zero-padded up to a bucket shape.
    Re-zeroing the pad before every spatial conv makes the valid region's
    outputs those of the unpadded SAME-padded frame (the JAX package's
    shape-bucketed eval)."""
    mh = (torch.arange(h, device=device) < valid_h).to(dtype)
    mw = (torch.arange(w, device=device) < valid_w).to(dtype)
    return (mh[:, None] * mw[None, :])[None, :, :, None]
