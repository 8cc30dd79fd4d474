"""Architecture one-hot encodings for the accuracy predictor (counterpart of
ofa_sr_tpu/search/encoder.py; numpy only, the same features bit for bit).

Per block a ks one-hot and an e one-hot, zeros for blocks past their
stage's depth; then a resolution one-hot (classification) or a pixel_d
one-hot (SR).
"""

from __future__ import annotations

import numpy as np

from ..models.arch import SearchSpace, SubnetConfig


def _onehot(value, choices):
    v = np.zeros(len(choices), np.float32)
    v[list(choices).index(value)] = 1.0
    return v


def _blocks(ks, e, d, n_stages, max_depth, ks_list, expand_list):
    feats = []
    for si in range(n_stages):
        for bi in range(max_depth):
            idx = si * max_depth + bi
            if bi < d[si]:
                feats.append(_onehot(ks[idx], ks_list))
                feats.append(_onehot(e[idx], expand_list))
            else:
                feats.append(np.zeros(len(ks_list), np.float32))
                feats.append(np.zeros(len(expand_list), np.float32))
    return feats


def encode_cls_arch(ks, e, d, image_size, *, ks_list=(3, 5, 7),
                    expand_list=(3, 4, 6), depth_list=(2, 3, 4),
                    n_stages=5, max_depth=4,
                    image_size_list=(160, 176, 192, 208, 224)):
    """Blockwise ks/e one-hots with depth masking, then the resolution
    one-hot (the reference's 128 features at its defaults)."""
    feats = _blocks(ks, e, d, n_stages, max_depth, ks_list, expand_list)
    feats.append(_onehot(image_size, image_size_list))
    return np.concatenate(feats)


def encode_sr_subnet(cfg: SubnetConfig, space: SearchSpace, n_trunks=1):
    """Blockwise ks/e one-hots of every trunk, then the pixel_d one-hot."""
    feats = _blocks(cfg.ks, cfg.e, cfg.d, space.n_stages * n_trunks, space.max_depth,
                    space.ks_list, space.expand_list)
    feats.append(_onehot(cfg.pixel_d, space.pixel_d_list))
    return np.concatenate(feats)
