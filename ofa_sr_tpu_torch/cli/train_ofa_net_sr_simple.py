"""Progressive shrinking of the SR supernet (counterpart of
ofa_sr_tpu/cli/train_ofa_net_sr_simple.py).

An OFAMobileNetX4 supernet shrunk task by task, pretrain -> kernel ->
depth (phases 1, 2) -> expand (phases 1, 2) -> pixelshuffle_depth, each
warm-starting from the previous task's checkpoint (`--warmstart`), with each
task's hyperparameters from the phase table. `--mode sr` trains the decoder
alone on bicubic LR inputs (the README's configuration), `--mode
autoencoder` the learned downscale and the SR together on the HR frames.
With `--kd_ratio` > 0, `--kd_teacher` names a checkpoint of this port of a
ks7/e6/d4/pixel_d 2 X4 net, the KD teacher.

The JAX package's execution levers come through `add_common_args` ->
`add_perf_args` (cli/common.py): `--compute_dtype`, `--ks_switch`,
`--dw_switch [dw|project]` and `--dw_align`, mapped to the RunConfig as
JAX's `perf_config_kw` maps them. Left out is its `--remat` (the steps fit
the card's memory without rematerialization; ROADMAP queue 1 item 14).

Run: python -m ofa_sr_tpu_torch.cli.train_ofa_net_sr_simple \\
       --task pixelshuffle_depth --phase 2 [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import Div2KSetXXProvider
from ..models import OFAMobileNetX4, SearchSpace
from ..models.arch import reference_quirk_arch_x4, uniform_subnet
from ..train import RunConfig, SRRunManager
from ..train.checkpoint import checkpoint_state_dict, load_checkpoint
from ..train.shrink import supporting_elastic
from .common import add_common_args, make_net, make_sr_provider, perf_config_kw, set_seeds

# the reference's phase table
TASK_PHASES = {
    # the max-net pretraining whose checkpoint the kernel task warm-starts
    # from (its own hyperparameters are not in the reference: the kernel
    # task's)
    ("pretrain", 1): dict(path="exp/sr/normal2pixelshuffle",
                          dynamic_batch_size=1, n_epochs=120, base_lr=3e-2,
                          warmup_epochs=5, ks_list=[7], expand_list=[6],
                          depth_list=[4], pixel_d_list=[2]),
    ("kernel", 1): dict(path="exp/sr/normal2kernel", dynamic_batch_size=1,
                        n_epochs=120, base_lr=3e-2, warmup_epochs=5,
                        ks_list=[3, 5, 7], expand_list=[6], depth_list=[4],
                        pixel_d_list=[2]),
    ("depth", 1): dict(path="exp/sr/kernel2kernel_depth/phase1",
                       dynamic_batch_size=2, n_epochs=25, base_lr=2.5e-3,
                       warmup_epochs=0, ks_list=[3, 5, 7], expand_list=[6],
                       depth_list=[3, 4], pixel_d_list=[2]),
    ("depth", 2): dict(path="exp/sr/kernel2kernel_depth/phase2",
                       dynamic_batch_size=2, n_epochs=120, base_lr=7.5e-3,
                       warmup_epochs=5, ks_list=[3, 5, 7], expand_list=[6],
                       depth_list=[2, 3, 4], pixel_d_list=[2]),
    ("expand", 1): dict(path="exp/sr/kernel_depth2kernel_depth_width/phase1",
                        dynamic_batch_size=4, n_epochs=25, base_lr=2.5e-3,
                        warmup_epochs=0, ks_list=[3, 5, 7], expand_list=[4, 6],
                        depth_list=[2, 3, 4], pixel_d_list=[2]),
    ("expand", 2): dict(path="exp/sr/kernel_depth2kernel_depth_width/phase2",
                        dynamic_batch_size=4, n_epochs=120, base_lr=7.5e-3,
                        warmup_epochs=5, ks_list=[3, 5, 7],
                        expand_list=[3, 4, 6], depth_list=[2, 3, 4],
                        pixel_d_list=[2]),
    ("pixelshuffle_depth", 1): dict(
        path="exp/sr/sr_bn_mse_4xLarge2pixelShuffle", dynamic_batch_size=1,
        n_epochs=25, base_lr=1e-4, warmup_epochs=5, ks_list=[7],
        expand_list=[6], depth_list=[4], pixel_d_list=[1, 2]),
}
TASK_PHASES[("pixelshuffle_depth", 2)] = TASK_PHASES[("pixelshuffle_depth", 1)]


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", type=str, default="pixelshuffle_depth",
                   choices=["pretrain", "kernel", "depth", "expand", "pixelshuffle_depth"])
    p.add_argument("--phase", type=int, default=2, choices=[1, 2])
    p.add_argument("--warmstart", type=str, default=None,
                   help="checkpoint dir/file of the previous task's best")
    p.add_argument("--reference_quirks", action="store_true",
                   help="train the architectures the reference executes (its runtime_depth "
                        "indexing, models/arch.reference_quirk_arch_x4)")
    p.add_argument("--mode", type=str, default="sr", choices=["sr", "autoencoder"],
                   help="sr: the decoder on bicubic LR (the README config); autoencoder: "
                        "learned downscale + SR")
    p.add_argument("--sandwich", action="store_true",
                   help="sandwich rule: subnet k=0 of every step is the max corner within the "
                        "stage's constraints. Needs --dynamic_batch_size >= 2")
    p.add_argument("--corner_gate", action="store_true",
                   help="snapshot per-corner best weights during validation "
                        "(best_<corner>.pth.tar and corner_best.json). Needs "
                        "--validation_frequency <= n_epochs to fire")
    p.add_argument("--kd_teacher", type=str, default=None,
                   help="checkpoint dir/file of this port's trained max net (ks7/e6/d4/pd2 "
                        "X4), the KD teacher when --kd_ratio > 0")
    # None: the TASK_PHASES preset applies unless given on the command line
    add_common_args(p, path=None, n_epochs=None, base_lr=None, batch_size=16,
                    warmup_epochs=None, dynamic_batch_size=None)
    return p.parse_args(argv)


def kd_teacher(args):
    """(net, subnet) of the --kd_teacher checkpoint: an X4 max net."""
    t_space = SearchSpace(ks_list=[7], expand_list=[6], depth_list=[4], pixel_d_list=[2])
    t_net = make_net(OFAMobileNetX4, t_space, args)
    t_net.load_state_dict(checkpoint_state_dict(load_checkpoint(args.kd_teacher)))
    t_cfg = uniform_subnet(t_space, 7, 6, 4, 2, n_trunks=t_net.n_trunks)
    if args.reference_quirks:
        # the teacher was trained on the architecture the reference executes
        t_cfg = reference_quirk_arch_x4(t_cfg)
    return t_net, t_cfg


def main(argv=None):
    args = build_args(argv)
    preset = TASK_PHASES[(args.task, args.phase)]
    for key in ("path", "n_epochs", "base_lr", "warmup_epochs", "dynamic_batch_size"):
        if getattr(args, key, None) is None:
            setattr(args, key, preset[key])
    set_seeds(args.manual_seed)

    space = SearchSpace(ks_list=preset["ks_list"], expand_list=preset["expand_list"],
                        depth_list=preset["depth_list"], pixel_d_list=preset["pixel_d_list"])
    net = make_net(OFAMobileNetX4, space, args)
    provider = make_sr_provider(args, Div2KSetXXProvider)

    teacher, kd_ratio = None, args.kd_ratio
    if kd_ratio > 0 and args.kd_teacher:
        teacher = kd_teacher(args)
    elif kd_ratio > 0:
        kd_ratio = 0.0  # no teacher checkpoint

    cfg = RunConfig(
        n_epochs=args.n_epochs, base_lr=args.base_lr,
        warmup_epochs=args.warmup_epochs, warmup_lr=args.warmup_lr,
        opt_type=args.opt_type, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm or None,
        train_batch_size=args.base_batch_size,
        dynamic_batch_size=args.dynamic_batch_size,
        validation_frequency=args.validation_frequency,
        print_frequency=args.print_frequency,
        save_frequency=args.save_frequency, kd_ratio=kd_ratio,
        manual_seed=args.manual_seed, mode=args.mode,
        bn_momentum=args.bn_momentum, bn_eps=args.bn_eps,
        image_size=args.image_size, reference_quirks=args.reference_quirks,
        sandwich_rule=args.sandwich, corner_gate=args.corner_gate,
        **perf_config_kw(args))
    rm = SRRunManager(args.path, net, cfg, provider, teacher=teacher)

    # the validation grid: each dimension's min and max, every pixel_d
    validate_lists = {"ks_list": sorted({min(space.ks_list), max(space.ks_list)}),
                      "expand_list": sorted({min(space.expand_list), max(space.expand_list)}),
                      "depth_list": sorted({min(space.depth_list), max(space.depth_list)}),
                      "pixel_d_list": sorted(space.pixel_d_list)}
    best = supporting_elastic(rm, args.task, warmstart_path=args.warmstart,
                              validate_lists=validate_lists)
    rm.write_log("task %s phase %d done: best psnr %.3f" % (args.task, args.phase, best),
                 "valid")
    return best


if __name__ == "__main__":
    main()
