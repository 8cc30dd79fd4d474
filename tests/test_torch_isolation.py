"""The port (ofa_sr_tpu_torch), chip_smoke.py, bn_path_times.py and
rank_launch.py never
import JAX or the JAX package: at run time (a fresh interpreter that
imports every module) and in the source."""

import os
import pkgutil
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ofa_sr_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ofa_sr_tpu)(\.|\s|$|,)", re.M)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PORT], "ofa_sr_tpu_torch."))


def test_importing_the_port_loads_no_jax():
    """Nor PIL: the GPU machine may lack it, and the synthetic data path and
    the CLIs run without it (PIL is imported where an image is opened)."""
    mods = _port_modules()
    for m in ("ops.kernels.mbconv", "ops.kernels.bn_stats", "ops.kernels.bn", "ops.norm",
              "data.providers", "data.transforms", "data.datasets",
              "train.run_manager", "train.bn_recalib", "cli.common",
              "cli.train_teacher_net_sr_simple", "cli.eval_ofa_net_sr", "models.ofa_x4",
              "models.reorganize", "train.shrink", "cli.train_ofa_net_sr_simple",
              "parallel.mesh", "parallel.spatial", "train.tiled_infer", "search",
              "search.flops", "search.encoder", "search.evolution", "search.accuracy_predictor",
              "search.latency", "data.bicubic", "data.native",
              "cli.train_teacher_net_sr_oracle_video", "cli.train_ofa_net_sr_oracle_video"):
        assert "ofa_sr_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        "for m in %r + ['chip_smoke', 'bn_path_times', 'rank_launch']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ofa_sr_tpu', 'PIL'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n" % mods)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_no_jax_imports_in_port_sources():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "bn_path_times.py",
                                                     "rank_launch.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            src = f.read()
        hit = FORBIDDEN.search(src)
        assert hit is None, "%s imports %r" % (path, hit.group(0))
    # the pattern does catch what it must
    for line in ("import jax", "from jax import numpy", "import ofa_sr_tpu.ops",
                 "from ofa_sr_tpu.models import arch", "from ofa_sr_tpu import x"):
        assert FORBIDDEN.search(line), line
    assert not FORBIDDEN.search("from ofa_sr_tpu_torch.ops import conv")
