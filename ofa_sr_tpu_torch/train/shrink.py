"""Progressive shrinking: the validation grid and the stage machine
(counterpart of ofa_sr_tpu/train/shrink.py, the reference's
progressive_shrinking.py).

A task loads the previous task's weights, walks its dimension's candidate
lists from largest to smallest (each stage adds the next smaller value to
the sampler's constraints), retrains, and records its progress in
`<path>/<task>.stage` (JSON), so a rerun resumes at the stage, and within a
stage at the epoch, where the last run stopped. The expand task reorganizes
the MBConv middle channels before each stage (models/reorganize.py), in
place: the optimizer's state keeps its order, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..models.arch import uniform_subnet
from ..models.reorganize import reorganize_s4, reorganize_x4
from .run_manager import SRRunManager


def _min_max(vals):
    return sorted({min(vals), max(vals)})


def _grid(run_manager, *, ks_list=None, expand_list=None, depth_list=None, pixel_d_list=None):
    """((pixel_d, d, e, ks), uniform subnet) over the grid; a dimension's
    default is its min and max (the reference's validate_func_dict),
    pixel_d's every value."""
    sp = run_manager.net.space
    return [((pd, d, e, k), uniform_subnet(sp, k, e, d, pd, n_trunks=run_manager.net.n_trunks))
            for pd in pixel_d_list or sorted(sp.pixel_d_list)
            for d in depth_list or _min_max(sp.depth_list)
            for e in expand_list or _min_max(sp.expand_list)
            for k in ks_list or _min_max(sp.ks_list)]


def corner_name(pd, d, e, k):
    """A grid corner's name, as validation logs and per-corner gating
    name it."""
    return "K%d-E%d-D%d-PD%d" % (k, e, d, pd)


def validate_grid(run_manager: SRRunManager, *, ks_list=None, expand_list=None,
                  depth_list=None, pixel_d_list=None, loader=None, gate_where=None):
    """Validate every corner of the grid (as the reference's architectures
    execute them under `reference_quirks`). Returns (mean loss, mean PSNR,
    log); with `gate_where` (where it runs, for the record) the corners also
    feed per-corner best gating."""
    losses, psnrs, log, gated = [], [], "", []
    for corner, cfg in _grid(run_manager, ks_list=ks_list, expand_list=expand_list,
                             depth_list=depth_list, pixel_d_list=pixel_d_list):
        loss, psnr = run_manager.validate(run_manager._quirk_cfg(cfg), loader=loader)
        losses.append(loss)
        psnrs.append(psnr)
        gated.append((corner_name(*corner), psnr))
        log += "PD%s-D%s-E%s-K%s (%.3f), " % (corner + (psnr,))
    if gate_where is not None:
        run_manager.gate_corners(gated, where=gate_where)
    return float(np.mean(losses)), float(np.mean(psnrs)), log


def _named_grid_cfgs(run_manager, vl):
    """The corners `validate_grid` walks for validate lists `vl`, named as
    the per-corner gating names them."""
    return [(corner_name(*corner), cfg) for corner, cfg in _grid(
        run_manager, **{k: vl.get(k) for k in ("ks_list", "expand_list", "depth_list",
                                               "pixel_d_list")})]


def _stage_file(run_manager, task):
    return os.path.join(run_manager.path, "%s.stage" % task)


def load_stage_info(run_manager, task):
    """{"stage": 0} for a missing file (a fresh task); a corrupt file
    raises, since restarting at stage 0 would retrain finished stages and
    overwrite their checkpoints."""
    path = _stage_file(run_manager, task)
    if not os.path.exists(path):
        return {"stage": 0}
    with open(path) as f:
        try:
            info = json.load(f)
        except ValueError as e:
            raise RuntimeError("corrupt stage file %s: %s; delete it to restart the %s "
                               "curriculum from stage 0" % (path, e, task))
    if not isinstance(info, dict) or "stage" not in info:
        raise RuntimeError("stage file %s has no 'stage' key; delete it to restart the %s "
                           "curriculum from stage 0" % (path, task))
    return info


def save_stage_info(run_manager, task, info):
    with open(_stage_file(run_manager, task), "w") as f:
        json.dump(info, f, indent=4)


def supporting_elastic(run_manager: SRRunManager, task: str, *,
                       warmstart_path: Optional[str] = None,
                       validate_lists: Optional[dict] = None):
    """The stage machine of `task`, one of pretrain, kernel, depth, expand
    and pixelshuffle_depth; returns the last stage's best mean PSNR (-1e9
    when no stage was left to run).

    pretrain and kernel: one stage over the whole space, resuming from the
    run's own checkpoint. depth, expand and pixelshuffle_depth: the stages
    from `<task>.stage` on; a stage that a killed run left running
    ("running_stage") resumes from its checkpoint, a new one first writes
    the checkpoint it would resume from (epoch -1). After each stage:
    `<task>_stage<n>.ckpt`, the stage file, and the grid's validation.
    """
    sp = run_manager.net.space
    vl = dict(validate_lists or {})

    if warmstart_path is not None and os.path.exists(
            warmstart_path if os.path.isfile(warmstart_path)
            else os.path.join(warmstart_path, "latest.txt")):
        run_manager.load_weights(warmstart_path)
        loss, psnr, log = validate_grid(run_manager, **vl, gate_where="warmstart")
        run_manager.write_log("warmstart: %.3f\t%.3f\t%s" % (loss, psnr, log), "valid")

    if task in ("kernel", "pretrain"):
        run_manager.load_model()  # resumes mid-phase; a missing checkpoint starts fresh
        best = run_manager.train(validate_cfgs=_named_grid_cfgs(run_manager, vl))
        save_stage_info(run_manager, task, {"stage": 1})
        return best

    stage_list = {"depth": sorted(sp.depth_list, reverse=True),
                  "expand": sorted(sp.expand_list, reverse=True),
                  "pixelshuffle_depth": sorted(sp.pixel_d_list, reverse=True)}[task]
    info = load_stage_info(run_manager, task)
    best = -1e9
    for stage in range(int(info.get("stage", 0)), len(stage_list) - 1):
        supported = stage_list[:stage + 2]
        run_manager.write_log("-" * 30 + " Elastic %s: %s -> %s " % (
            task, stage_list[:stage + 1], supported) + "-" * 30, "valid")
        if task == "expand":
            reorg = reorganize_x4 if run_manager.net.n_trunks == 2 else reorganize_s4
            reorg(run_manager.net, expand_ratio_stage=stage + 1)

        if task == "depth":
            constraints = {"depth_candidates": supported}
            vl["depth_list"] = (_min_max(supported)
                                if len(sp.ks_list) > 1 or len(sp.expand_list) > 1
                                else sorted(supported))
        elif task == "expand":
            constraints = {"expand_candidates": supported}
            vl["expand_list"] = _min_max(supported)
        else:
            constraints = {"pixel_d_candidates": supported}
            vl["pixel_d_list"] = sorted(supported)

        run_manager.start_epoch = 0
        run_manager.best_acc = -1e9
        if int(info.get("running_stage", -1)) == stage:
            # the stage's own checkpoint holds the weights after its
            # reorganize, the optimizer and the epoch to resume at
            run_manager.load_model()
        else:
            info["running_stage"] = stage
            save_stage_info(run_manager, task, info)
            # without it a crash in epoch 0 would resume from the previous
            # stage's last checkpoint, whose epoch would skip this stage
            run_manager.save_model(epoch=-1)
        best = run_manager.train(constraints=constraints,
                                 validate_cfgs=_named_grid_cfgs(run_manager, vl))

        info.pop("running_stage", None)
        info["stage"] = stage + 1
        run_manager.save_model(epoch=run_manager.run_config.n_epochs - 1,
                               name="%s_stage%d.ckpt" % (task, info["stage"]))
        save_stage_info(run_manager, task, info)
        loss, psnr, log = validate_grid(run_manager, **vl,
                                        gate_where="stage %d end" % info["stage"])
        run_manager.write_log("stage %d: %.3f\t%.3f\t%s" % (info["stage"], loss, psnr, log),
                              "valid")
    return best
