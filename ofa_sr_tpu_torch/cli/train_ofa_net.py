"""ImageNet OFA progressive shrinking (counterpart of
ofa_sr_tpu/cli/train_ofa_net.py, the reference's train_ofa_net.py).

OFAMobileNetV3 with KD from a ks7/e6/d4 teacher checkpoint (kd_ratio 1.0),
the task/phase schedule over kernel -> depth -> expand (TASK_PHASES), the
elastic resolution 128-224 drawn per batch, the global batch and the LR
scaled by the world size. The world is the processes torchrun starts
(`torchrun --nproc_per_node=N -m ofa_sr_tpu_torch.cli.train_ofa_net ...`,
one a GPU, `cli/common.init_mesh`); with more than one the run is
data-parallel (`ClsRunManager(mesh=)`); launched plainly it is this
process alone.

Run: python -m ofa_sr_tpu_torch.cli.train_ofa_net --task kernel [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse

from ..data import ElasticResolution, ImagenetProvider, SyntheticClsProvider
from ..models import OFAMobileNetV3
from ..train import ClsRunManager, RunConfig
from ..train.checkpoint import load_weights_strict
from .common import add_device_arg, add_perf_args, init_mesh, perf_config_kw, seeded, set_seeds

# the reference's task table (train_ofa_net.py:33-106)
TASK_PHASES = {
    ("kernel", 1): dict(path="exp/cls/normal2kernel", dynamic_batch_size=1,
                        n_epochs=120, base_lr=3e-2, warmup_epochs=5,
                        ks_list=[3, 5, 7], expand_list=[6], depth_list=[4]),
    ("depth", 1): dict(path="exp/cls/kernel2kernel_depth/phase1",
                       dynamic_batch_size=2, n_epochs=25, base_lr=2.5e-3,
                       warmup_epochs=0, ks_list=[3, 5, 7], expand_list=[6],
                       depth_list=[3, 4]),
    ("depth", 2): dict(path="exp/cls/kernel2kernel_depth/phase2",
                       dynamic_batch_size=2, n_epochs=120, base_lr=7.5e-3,
                       warmup_epochs=5, ks_list=[3, 5, 7], expand_list=[6],
                       depth_list=[2, 3, 4]),
    ("expand", 1): dict(path="exp/cls/kernel_depth2kernel_depth_width/phase1",
                        dynamic_batch_size=4, n_epochs=25, base_lr=2.5e-3,
                        warmup_epochs=0, ks_list=[3, 5, 7],
                        expand_list=[4, 6], depth_list=[2, 3, 4]),
    ("expand", 2): dict(path="exp/cls/kernel_depth2kernel_depth_width/phase2",
                        dynamic_batch_size=4, n_epochs=120, base_lr=7.5e-3,
                        warmup_epochs=5, ks_list=[3, 5, 7],
                        expand_list=[3, 4, 6], depth_list=[2, 3, 4]),
}


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", type=str, default="kernel", choices=["kernel", "depth", "expand"])
    p.add_argument("--phase", type=int, default=1, choices=[1, 2])
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    add_device_arg(p)
    p.add_argument("--path", type=str, default=None)
    p.add_argument("--base_batch_size", type=int, default=64,
                   help="per-device batch; the global batch is this times the world size")
    p.add_argument("--image_size", type=str, default="128,160,192,224")
    p.add_argument("--kd_ratio", type=float, default=1.0)
    p.add_argument("--teacher_ckpt", type=str, default=None)
    p.add_argument("--manual_seed", type=int, default=0)
    p.add_argument("--warmstart", type=str, default=None)
    p.add_argument("--n_epochs", type=int, default=None)
    add_perf_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = build_args(argv)
    preset = TASK_PHASES[(args.task, args.phase)]
    set_seeds(args.manual_seed)
    mesh = init_mesh(args)
    global_bs = args.base_batch_size * mesh.world
    # init_lr = base_lr * the number of devices (the reference's :150)
    base_lr = preset["base_lr"] * mesh.world

    net = OFAMobileNetV3(ks_list=preset["ks_list"], expand_list=preset["expand_list"],
                         depth_list=preset["depth_list"], device=mesh.device,
                         generator=seeded(args))
    sizes = [int(s) for s in args.image_size.split(",")]
    if args.synthetic:
        provider = SyntheticClsProvider(n_train=global_bs * 4, n_test=64, image_size=max(sizes),
                                        n_classes=1000, train_batch_size=global_bs)
    else:
        provider = ImagenetProvider(root=args.data_root, image_size=max(sizes),
                                    train_batch_size=global_bs,
                                    elastic=ElasticResolution(sizes, sync_distributed=True))

    teacher, kd_ratio = None, args.kd_ratio
    if kd_ratio > 0 and args.teacher_ckpt:
        t_net = OFAMobileNetV3(ks_list=[7], expand_list=[6], depth_list=[4], device=mesh.device)
        teacher = (load_weights_strict(args.teacher_ckpt, t_net), t_net.max_arch())
    elif kd_ratio > 0:
        kd_ratio = 0.0  # no teacher checkpoint given

    n_epochs = args.n_epochs if args.n_epochs is not None else preset["n_epochs"]
    cfg = RunConfig(n_epochs=n_epochs, base_lr=base_lr, warmup_epochs=preset["warmup_epochs"],
                    opt_type="sgd", weight_decay=3e-5, train_batch_size=global_bs,
                    dynamic_batch_size=preset["dynamic_batch_size"], kd_ratio=kd_ratio,
                    kd_type="ce", manual_seed=args.manual_seed,
                    **perf_config_kw(args))
    rm = ClsRunManager(args.path or preset["path"], net, cfg, provider, teacher=teacher,
                       mesh=mesh if mesh.world > 1 else None)
    if args.warmstart:
        rm.load_weights(args.warmstart)
    best = rm.train()
    rm.write_log("task %s phase %d: best top1 %.2f" % (args.task, args.phase, best), "valid")
    return best


if __name__ == "__main__":
    main()
