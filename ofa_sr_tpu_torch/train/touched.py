"""Which parameters a training step touches (counterpart of
ofa_sr_tpu/train/touched.py `sr_touched_mask` and `cls_touched_mask`).

torch's optimizers skip a parameter whose grad is None: a module no sampled
subnet executed in a step (blocks past a stage's depth, the transform
matrices of kernel sizes not drawn, shuffle stages past pixel_d, the X4
encoder in sr mode) gets no weight decay, no moment update and no step
count. The eager step gets that from PyTorch itself. The graphed step's
gradients are static zero-filled tensors, which have no None, so it gates
its optimizer (`optim.GatedOpt`) on this mask instead, rebuilt on the host
from the step's subnets as the JAX package rebuilds it for `TorchOpt`.
"""

from __future__ import annotations


def _kt_used(ks_list, ks_used):
    """The transform matrices ('<K>to<k>') that the chain pulls in for the
    executed kernel sizes: largest to smallest, down to each target."""
    ks_set = sorted(set(ks_list))
    used = set()
    for k in ks_used:
        for j in range(len(ks_set) - 1, ks_set.index(k), -1):
            used.add("%dto%d" % (ks_set[j], ks_set[j - 1]))
    return used


def _block_touched(out, key, ks_list, ks_used):
    """Mark the parameters under `key` (an MBConv block's prefix): touched
    where some subnet ran the block (`ks_used`, the kernel sizes it ran at,
    not empty), its transform matrices by `_kt_used`."""
    used = _kt_used(ks_list, ks_used)
    for name in out:
        if name.startswith(key):
            matrix = name.endswith("_matrix") and name.rsplit(".", 1)[1][:-len("_matrix")]
            out[name] = bool(ks_used) and (not matrix or matrix in used)


def _trunk_touched(out, prefix, block_offset, space, cfgs, trunk):
    """Mark trunk `trunk`'s MBConv blocks, `blocks.<block_offset + bi>`:
    block bi of stage s runs where bi % max_depth < d[s] for some subnet
    (min'ed with max_depth, JAX's rule)."""
    md = space.max_depth
    base_b, base_s = trunk * space.blocks_per_trunk, trunk * space.n_stages
    for bi in range(space.blocks_per_trunk):
        si, pos = bi // md, bi % md
        runs = [c for c in cfgs if pos < min(c.d[base_s + si], md)]
        _block_touched(out, "%s%d." % (prefix, block_offset + bi), space.ks_list,
                       {c.ks[base_b + bi] for c in runs})


def sr_touched_mask(net, cfgs, mode="sr"):
    """{parameter name: touched} over `net.named_parameters()` for an
    OFAMobileNetS4 or OFAMobileNetX4 given the subnets (quirks applied) a
    step executes: the static convs of the decoder always, the shuffle
    blocks below the largest pixel_d, the MBConv blocks by their stage
    depths and the matrices by the kernel sizes drawn; the X4 encoder
    (unshuffle blocks below pixel_d, its trunk, its final convs) in
    `mode="autoencoder"` only."""
    sp = net.space
    out = {name: True for name, _ in net.named_parameters()}
    max_pd = max(c.pixel_d for c in cfgs)
    n_shuffle = net.n_shuffle

    def fill(prefix, value):
        for name in out:
            if name.startswith(prefix):
                out[name] = value

    if net.n_trunks == 2:
        enc_on = mode == "autoencoder"
        for i in range(n_shuffle):
            fill("blocks.%d." % i, enc_on and i < max_pd)
        enc0 = n_shuffle
        if enc_on:
            _trunk_touched(out, "blocks.", enc0, sp, cfgs, 0)
        else:
            for bi in range(enc0, enc0 + sp.blocks_per_trunk):
                fill("blocks.%d." % bi, False)
        fill("enc_final_conv_blocks.", enc_on)
        dec0, trunk = n_shuffle + sp.blocks_per_trunk, 1
    else:
        dec0, trunk = 0, 0
    _trunk_touched(out, "blocks.", dec0, sp, cfgs, trunk)
    shuffle0 = dec0 + sp.blocks_per_trunk
    for i in range(n_shuffle):
        fill("blocks.%d." % (shuffle0 + i), i < max_pd)
    return out


def cls_touched_mask(net, archs):
    """{parameter name: touched} over `net.named_parameters()` for an
    ElasticClassifierNet given the ClsArchs a step executes: everything
    outside the elastic blocks always; elastic block i of a stage where
    i == 0 or i < d for some subnet, its matrices by the kernel sizes drawn.
    Elastic width never changes touched-ness: torch gives a sliced weight
    its whole (zero-padded) gradient."""
    out = {name: True for name, _ in net.named_parameters()}
    bi = 0
    for si, spec in enumerate(net.stage_specs):
        for i in range(spec.n_block):
            runs = [a for a in archs if i == 0 or i < a.d[si]]
            _block_touched(out, "blocks.%d." % (1 + bi), net.space.ks_list,
                           {a.ks[bi] for a in runs})
            bi += 1
    return out
