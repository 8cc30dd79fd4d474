"""End-to-end OFA-SR walkthrough on the port (counterpart of
tutorial/ofa_tpu_tutorial.py): train a small supernet, evaluate subnet
corners, build an efficiency table, fit a quality predictor, run the
evolutionary search under a FLOPs constraint, deploy the winner as a
materialized subnet through the hand-written kernels, serialize it and
export it as a serving artifact, and run a large frame tiled.

Runs on the GPU (or with `--device cpu`) on synthetic data:
    python -m ofa_sr_tpu_torch.tutorial [--device cpu] [--path DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from .data import SyntheticSRProvider
from .models import OFAMobileNetS4, SearchSpace, SubnetConfig, get_active_subnet, sample_subnet
from .models.arch import uniform_subnet
from .models.export import export_subnet, load_subnet
from .ops.kernels import fused_mbconv_infer, fused_shuffle_tail
from .search import AccuracyPredictor, EvolutionFinder, FLOPsTable, encode_sr_subnet
from .search import measure_latency
from .train import RunConfig, SRRunManager
from .train.tiled_infer import receptive_field_radius, tiled_sr_infer
from .utils.device import resolve_device


def main(argv=None):
    """Runs the walkthrough and returns what it printed, as a dict: the
    corners' PSNR-Y, the winner (and its SubnetConfig dict), its MACs and
    predicted and measured PSNR-Y, its deployed ms per frame, the serving
    kernels' launches in the deployed frame, the artifact's bytes and its
    largest difference from the plain path."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--path", default="exp/tutorial_torch")
    p.add_argument("--n_epochs", type=int, default=2)
    p.add_argument("--n_predictor_subnets", type=int, default=48)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # -- 1. a small SR supernet and a short progressive-shrinking-style run --
    space = SearchSpace(ks_list=[3, 5, 7], expand_list=[3, 4, 6], depth_list=[2, 3, 4],
                        pixel_d_list=[1, 2], n_stages=2, width=16)
    net = OFAMobileNetS4(space, device=dev)
    provider = SyntheticSRProvider(n_train=32, n_valid=4, hr_size=32, train_batch_size=8)
    cfg = RunConfig(n_epochs=args.n_epochs, base_lr=1e-3, train_batch_size=8,
                    dynamic_batch_size=2, print_frequency=2)
    rm = SRRunManager(args.path, net, cfg, provider)
    print("== training the supernet (%d epochs, 2 subnets/step) ==" % args.n_epochs)
    rm.train()

    # -- 2. validate the corners of every elastic dimension ------------------
    print("\n== subnet corners ==")
    out["corners"] = {}
    for name, c in {
        "max (k7 e6 d4 pd2)": uniform_subnet(space, 7, 6, 4, 2),
        "min (k3 e3 d2 pd1)": uniform_subnet(space, 3, 3, 2, 1),
        "mid (k5 e4 d3 pd1)": uniform_subnet(space, 5, 4, 3, 1),
    }.items():
        _, psnr = rm.validate(c)
        out["corners"][name] = psnr
        print("  %-20s psnr %.3f" % (name, psnr))

    # -- 3. efficiency: closed-form FLOPs table + measured latency -----------
    table = FLOPsTable(space, hr_size=32, conv_ks=5)
    max_macs = table.predict_efficiency(uniform_subnet(space, 7, 6, 4, 1))
    print("\n== efficiency ==")
    print("  max-subnet MACs @32px: %.1fM" % (max_macs / 1e6))
    sub = get_active_subnet(net, uniform_subnet(space, 7, 6, 4, 1))
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 16, 16, 3, generator=g).to(dev)
    out["max_subnet_ms"] = measure_latency(sub, x, warmup=2, iters=5)
    print("  materialized max subnet: %.2f ms/frame" % out["max_subnet_ms"])

    # -- 4. quality predictor: sample subnets, measure, fit the MLP ----------
    n = args.n_predictor_subnets
    print("\n== fitting the PSNR predictor on %d sampled subnets ==" % n)
    cfgs = [sample_subnet(space, seed=i) for i in range(n)]
    feats = np.stack([encode_sr_subnet(c, space) for c in cfgs])
    targets = np.asarray([rm.validate(c)[1] for c in cfgs], np.float32)
    pred = AccuracyPredictor(in_dim=feats.shape[1], hidden=64, n_layers=2, device=dev)
    pred.fit(feats, targets, epochs=60, lr=3e-3)

    # -- 5. evolutionary search under a FLOPs constraint ----------------------
    constraint = 0.5 * max_macs
    print("\n== evolution: maximize predicted PSNR under %.1fM MACs ==" % (constraint / 1e6))

    def quality(c):
        return float(pred.predict(encode_sr_subnet(c, space))[0])

    finder = EvolutionFinder(space, table.predict_efficiency, quality, population_size=24,
                             max_time_budget=8, seed=0)
    best, score, _ = finder.run(constraint)
    out["winner"] = best.describe()
    out["winner_cfg"] = best.to_dict()
    out["winner_macs"] = table.predict_efficiency(best)
    out["predicted_psnr"] = score
    print("  winner: %s" % best.describe()[:70])
    print("  predicted psnr %.3f | MACs %.1fM (constraint %.1fM)"
          % (score, out["winner_macs"] / 1e6, constraint / 1e6))
    out["measured_psnr"] = rm.validate(best)[1]
    print("  measured psnr %.3f" % out["measured_psnr"])

    # -- 6. deploy: the materialized winner, through the kernels on a GPU -----
    winner = get_active_subnet(net, best)
    lr_hw = 32 // (2 ** best.pixel_d)
    xin = torch.rand(1, lr_hw, lr_hw, 3, generator=g).to(dev)
    launches = fused_mbconv_infer.launches, fused_shuffle_tail.launches
    with torch.inference_mode():
        y = winner(xin)
    out["deployed_launches"] = {"mbconv": fused_mbconv_infer.launches - launches[0],
                                "shuffle_tail": fused_shuffle_tail.launches - launches[1]}
    out["deployed_ms"] = measure_latency(winner, xin, warmup=2, iters=5)
    print("\n== deployed ==")
    print("  %s -> %s in %.2f ms/frame (BN folded, %s path)"
          % (tuple(xin.shape), tuple(y.shape), out["deployed_ms"],
             "kernel" if winner.use_kernels else "plain"))

    # -- 7. serialize the winner (the SR side's net.config) -------------------
    arch_json = json.dumps(best.to_dict())
    print("\n== serialized winner (SubnetConfig JSON) ==")
    print("  %s" % arch_json[:76])
    assert SubnetConfig.from_dict(json.loads(arch_json)) == best

    # -- 7b. serving artifact: weights + program, no model code needed --------
    with torch.inference_mode():
        y_plain = get_active_subnet(net, best, use_kernels=False)(xin)
    with tempfile.TemporaryDirectory() as tdir:
        art = os.path.join(tdir, "winner.pt2")
        blob = export_subnet(net, best, (lr_hw, lr_hw), path=art)
        served = load_subnet(art, device=dev)
        with torch.inference_mode():
            y_served = served(xin)
    out["artifact_bytes"] = len(blob)
    out["artifact_max_abs_err_plain"] = float((y_served - y_plain).abs().max())
    out["artifact_max_abs_err_deployed"] = float((y_served - y).abs().max())
    print("\n== torch.export artifact ==")
    print("  %d bytes; largest difference from the plain path %.3g, from the deployed "
          "frame %.3g" % (len(blob), out["artifact_max_abs_err_plain"],
                          out["artifact_max_abs_err_deployed"]))

    # -- 8. big frames: overlap-tiled inference --------------------------------
    halo = receptive_field_radius(best, space)
    big = torch.rand(1, 72, 88, 3, generator=g).to(dev)
    with torch.inference_mode():
        y_big = tiled_sr_infer(winner, big, tile=16, halo=halo, scale=2 ** best.pixel_d)
    out["tiled_shape"] = tuple(y_big.shape)
    print("\n== tiled large-frame inference ==")
    print("  %s -> %s via 16px tiles, halo %d (receptive-field exact)"
          % (tuple(big.shape), tuple(y_big.shape), halo))
    return out


if __name__ == "__main__":
    main()
