"""Large frames over two ranks: the port's spatial inference, each rank's
slab with its halos (ofa_sr_tpu_torch/parallel/spatial.py `make_spatial_infer`), the
window batch split over the ranks (train/tiled_infer.py
`tiled_sr_infer_mesh`) and the evaluator's `--tile`, `--tile_mesh` and
`--spatial_mesh`, on the CPU.

The ranks are two processes over gloo on 127.0.0.1 (tests/test_torch_parallel.py's
launcher: one torch thread each, the run bounded in time). Nets and frames
are tests/test_torch_tiled.py's (width 16, one stage; the X4 autoencoder's
frames with their rows split into slabs smaller than the halo, so a
halo spans several slabs, and a frame whose rows do not split evenly).

Tolerances (float32): spatial frames against JAX `make_spatial_infer` on a
2-device CPU mesh 1e-4 (the JAX tests' own bound for the folded tail is
2e-4 abs against its full frame), against the port's full frame 1e-5;
`tiled_sr_infer_mesh` over two ranks against `tiled_sr_infer` 1e-6 (the
same windows in batches of another size); the evaluator's mean PSNR-Y
within 1e-4 dB of the untiled run.
"""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.parallel import make_mesh as jax_make_mesh
from ofa_sr_tpu.parallel.spatial import make_spatial_infer as jax_make_spatial_infer
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.train import tiled_infer as ttiled
from test_torch_parallel import _Done, _run_ranks
from test_torch_tiled import SPACE_KW, _halo, frame, run, subnets, twin_nets

WORLD = 2
# spatial cases: (kind, mode, pixel_d, fold_tail, frame shape)
SPATIAL = [("s4", "sr", pd, fold, (1, h, 16, 3))
           for pd in (1, 2) for fold in (True, False) for h in ((20, 21) if pd == 1 else (20,))]
SPATIAL += [("x4", "autoencoder", pd, fold, (1, 36 if pd == 1 else 40, 16, 3))
            for pd in (1, 2) for fold in (True, False)]
# tiled cases: (kind, mode, pixel_d, frame shape, tile, windows a rank)
TILED = [("s4", "sr", 1, (1, 40, 44, 3), 8, 1), ("s4", "sr", 1, (1, 40, 44, 3), 8, 2),
         ("x4", "autoencoder", 1, (1, 120, 128, 3), 16, 1)]
# the evaluator: a small subnet of the full-width default space; S4 frames
# of LR 56 (tiles of 20 + 2*17 halo rows: 3x3 windows), X4 autoencoder HR
# frames of 160 (its halo of 66 HR rows leaves --tile 64 one whole window;
# --spatial_mesh splits its rows)
EVAL = ["--synthetic", "--device", "cpu", "--dataset", "div2k", "--materialize", "--ks", "3",
        "--expand", "3", "--depth", "2", "--pixel_d", "1"]
EVAL_CASES = {"s4": ["--image_size", "112"], "ae": ["--image_size", "160", "--x4_autoencoder"]}
EVAL_FLAGS = {"s4": {"tile": ["--tile", "20"], "tile_mesh": ["--tile", "20", "--tile_mesh"],
                     "spatial_mesh": ["--spatial_mesh"]},
              "ae": {"tile": ["--tile", "64"], "tile_mesh": ["--tile", "64", "--tile_mesh"],
                     "spatial_mesh": ["--spatial_mesh"]}}

BODY = r"""
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.models import OFAMobileNetS4, OFAMobileNetX4, SearchSpace, get_active_subnet
from ofa_sr_tpu_torch.models.arch import uniform_subnet
from ofa_sr_tpu_torch.parallel import make_spatial_infer
from ofa_sr_tpu_torch.train import tiled_infer as ttiled
spec = json.load(open(os.path.join(d, "spec.json")))
space = SearchSpace(**spec["space"])
nets = {}
for kind, cls in (("s4", OFAMobileNetS4), ("x4", OFAMobileNetX4)):
    nets[kind] = cls(space, device="cpu")
    nets[kind].load_state_dict(torch.load(os.path.join(d, kind + ".pt")))

def subnet(kind, mode, pd, fold=True):
    cfg = uniform_subnet(space, 5, 3, 2, pd, n_trunks=nets[kind].n_trunks)
    sub = get_active_subnet(nets[kind], cfg, mode=mode, fold_tail=fold)
    if mode == "autoencoder":
        return sub, ttiled.receptive_field_radius_autoencoder(cfg, space), 1
    return sub, ttiled.receptive_field_radius(cfg, space), 2 ** pd

out = {}
with torch.no_grad():
    for i, (kind, mode, pd, fold, shape) in enumerate(spec["spatial"]):
        sub, halo, scale = subnet(kind, mode, pd, fold)
        x = torch.from_numpy(np.random.RandomState(i).rand(*shape).astype(np.float32))
        infer = make_spatial_infer(sub, mesh, halo=halo, scale=scale,
                                   align=2 ** pd if mode == "autoencoder" else 1)
        out["spatial%d" % i] = infer(x).numpy()
    for i, (kind, mode, pd, shape, tile, k) in enumerate(spec["tiled"]):
        sub, halo, scale = subnet(kind, mode, pd)
        x = torch.from_numpy(np.random.RandomState(50 + i).rand(*shape).astype(np.float32))
        out["tiled%d" % i] = ttiled.tiled_sr_infer_mesh(
            sub, x, tile=tile, halo=halo, scale=scale, mesh=mesh, windows_per_device=k).numpy()
np.savez(os.path.join(d, "out_%d.npz" % rank), **out)
psnr = {}
for net, extra in spec["eval_cases"].items():
    for flag in ("tile_mesh", "spatial_mesh"):
        psnr[net + " " + flag] = teval.main(spec["eval"] + extra + spec["eval_flags"][net][flag]
                                            + ["--path", os.path.join(d, "eval", net, flag)])
json.dump(psnr, open(os.path.join(d, "psnr_%d.json" % rank), "w"))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return twin_nets()


@pytest.fixture(scope="module")
def rank_run(nets, tmp_path_factory):
    """Every case run once over two ranks, in the background while the
    references compute here."""
    d = tmp_path_factory.mktemp("spatial")
    for kind in ("s4", "x4"):
        torch.save(nets[kind][3].state_dict(), d / (kind + ".pt"))
    with open(d / "spec.json", "w") as f:
        json.dump({"space": SPACE_KW, "spatial": SPATIAL, "tiled": TILED, "eval": EVAL,
                   "eval_cases": EVAL_CASES, "eval_flags": EVAL_FLAGS}, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield _Done(pool.submit(_run_ranks, d, BODY, timeout=400), d)


_RESULTS = {}


def ranks(rank_run):
    """Rank 0's frames and PSNRs, once both ranks have ended; every rank
    assembles the same frames and scores the same PSNRs."""
    if "out" not in _RESULTS:
        d = rank_run.result()
        outs = [dict(np.load(d / ("out_%d.npz" % r))) for r in range(WORLD)]
        psnrs = [json.load(open(d / ("psnr_%d.json" % r))) for r in range(WORLD)]
        for k in outs[0]:
            np.testing.assert_array_equal(outs[0][k], outs[1][k])
        assert psnrs[0] == psnrs[1]
        _RESULTS.update(out=outs[0], psnr=psnrs[0])
    return _RESULTS["out"], _RESULTS["psnr"]


@pytest.mark.parametrize("i", range(len(SPATIAL)),
                         ids=["%s-%s-pd%d-fold%d-h%d" % (k, m, pd, f, s[1])
                              for k, m, pd, f, s in SPATIAL])
def test_spatial_over_two_ranks_matches_jax_and_the_full_frame(nets, rank_run, i):
    """make_spatial_infer over two ranks against JAX's on two CPU devices,
    and against the port's full frame."""
    kind, mode, pd, fold, shape = SPATIAL[i]
    jsub, tsub, cfg = subnets(nets, kind, mode, pd, fold)
    halo, scale = _halo(tsub, cfg, mode)
    x = np.random.RandomState(i).rand(*shape).astype(np.float32)
    jrun = jax_make_spatial_infer(jsub, jax_make_mesh(jax.devices()[:WORLD]), halo=halo,
                                  scale=scale, align=2 ** pd if mode == "autoencoder" else 1)
    y_j = jrun(x)
    got = ranks(rank_run)[0]["spatial%d" % i]
    assert got.shape == y_j.shape
    np.testing.assert_allclose(got, y_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, run(tsub, x).numpy(), rtol=1e-5, atol=1e-5)
    assert halo > -(-shape[1] // WORLD)  # the halo spans more than a slab


@pytest.mark.parametrize("i", range(len(TILED)),
                         ids=["%s-%s-pd%d-k%d" % (c[0], c[1], c[2], c[5]) for c in TILED])
def test_tiled_mesh_over_two_ranks_matches_tiled(nets, rank_run, i):
    kind, mode, pd, shape, tile, _ = TILED[i]
    _, tsub, cfg = subnets(nets, kind, mode, pd)
    halo, scale = _halo(tsub, cfg, mode)
    x = torch.from_numpy(np.random.RandomState(50 + i).rand(*shape).astype(np.float32))
    with torch.no_grad():
        ref = ttiled.tiled_sr_infer(tsub, x, tile=tile, halo=halo, scale=scale)
    np.testing.assert_allclose(ranks(rank_run)[0]["tiled%d" % i], ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def one_process_evals(tmp_path_factory):
    """The evaluator in this process: whole frames and --tile."""
    d = tmp_path_factory.mktemp("eval")
    out = {}
    for net, extra in EVAL_CASES.items():
        for flag in ("whole", "tile"):
            argv = EVAL + extra + (EVAL_FLAGS[net][flag] if flag != "whole" else [])
            out[net + " " + flag] = teval.main(argv + ["--path", str(d / "one" / net / flag)])
    return out


@pytest.mark.parametrize("net", list(EVAL_CASES))
@pytest.mark.parametrize("flag", ["tile", "tile_mesh", "spatial_mesh"])
def test_evaluator_large_frame_options_match_the_whole_frame(rank_run, one_process_evals, net,
                                                             flag):
    """eval_ofa_net_sr --materialize with --tile (one process),
    --tile_mesh and --spatial_mesh (two ranks), on the S4 and with
    --x4_autoencoder: the mean PSNR-Y of the untiled run within 1e-4 dB."""
    psnrs = ranks(rank_run)[1]
    got = one_process_evals[net + " tile"] if flag == "tile" else psnrs[net + " " + flag]
    assert abs(got - one_process_evals[net + " whole"]) <= 1e-4
