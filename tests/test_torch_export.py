"""The port's serving artifact (ofa_sr_tpu_torch/models/export.py) against
its eager plain path and against the JAX package's jax.export artifact on
the CPU, from the same weights (the JAX init with random BN parameters and
statistics as tests/test_torch_train.py draws them, through the weight
bridge), and `eval_ofa_net_sr --export` end to end.

Tolerances: the loaded artifact against the port's eager plain path
(`get_active_subnet(..., use_kernels=False)`, `fold_tail` on) atol 1e-6
(the same ops; here they agree bit for bit); against JAX's loaded artifact
rtol and atol 1e-4, as tests/test_torch_x4.py holds static subnets to JAX,
except the X4 autoencoder's frame: through two trunks under random BN it
reaches |y| ~ 50, where float32 sums in another order differ by ~5e-6 of
the frame's largest value (2e-4 on elements near 1), so its largest
difference is held within 1e-4 of the frame's largest value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofa_sr_tpu.models import OFAMobileNetS4 as JaxS4
from ofa_sr_tpu.models import OFAMobileNetX4 as JaxX4
from ofa_sr_tpu.models import arch as jarch
from ofa_sr_tpu.models import export as jexport
from ofa_sr_tpu_torch.cli import eval_ofa_net_sr as teval
from ofa_sr_tpu_torch.models import (
    OFAMobileNetS4,
    OFAMobileNetX4,
    SearchSpace,
    get_active_subnet,
    uniform_subnet,
)
from ofa_sr_tpu_torch.models.export import ServedSubnet, export_fn, export_subnet, load_subnet
from ofa_sr_tpu_torch.train.checkpoint import s4_state_dict_from_jax, x4_state_dict_from_jax
from test_torch_train import _randomize_bn

SPACE_KW = dict(ks_list=[3, 5, 7], expand_list=[3, 6], depth_list=[1, 2], pixel_d_list=[1, 2],
                n_stages=2, width=16)
SELF_TOL = dict(rtol=0, atol=1e-6)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
# (net, mode, pixel_d): the S4 at both upscales, the X4 in both modes
CASES = [("s4", "sr", 1), ("s4", "sr", 2), ("x4", "autoencoder", 2), ("x4", "sr", 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for the module, restored after it: these nets'
    CPU convs gain little from intra-op threads and oversubscribe the CPU
    under parallel test workers (as tests/test_torch_x4.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(kind, seed=0):
    """The JAX net with random BN statistics and the port's twin."""
    jcls, tcls, bridge = {"s4": (JaxS4, OFAMobileNetS4, s4_state_dict_from_jax),
                          "x4": (JaxX4, OFAMobileNetX4, x4_state_dict_from_jax)}[kind]
    jnet = jcls(jarch.SearchSpace(**SPACE_KW))
    p, s = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    p, s = _randomize_bn(p, rng), _randomize_bn(s, rng)
    tnet = tcls(SearchSpace(**SPACE_KW), device="cpu")
    tnet.load_state_dict(bridge(p, s))
    return jnet, p, s, tnet


@pytest.mark.parametrize("kind,mode,pixel_d", CASES)
def test_artifact_matches_eager_and_jax(tmp_path, kind, mode, pixel_d):
    jnet, p, s, tnet = _nets(kind)
    n_trunks = tnet.n_trunks
    cfg = uniform_subnet(tnet.space, 7, 6, 2, pixel_d, n_trunks=n_trunks)
    jcfg = jarch.uniform_subnet(jnet.space, 7, 6, 2, pixel_d, n_trunks=n_trunks)
    hw = (12, 20) if mode == "sr" else (12 * 2 ** pixel_d, 20 * 2 ** pixel_d)
    x = np.random.RandomState(2).rand(2, *hw, 3).astype(np.float32)
    path = str(tmp_path / "subnet.pt2")
    blob = export_subnet(tnet, cfg, hw, batch=2, mode=mode, path=path)
    assert os.path.getsize(path) == len(blob)
    with torch.no_grad():
        eager = get_active_subnet(tnet, cfg, mode=mode, use_kernels=False)(torch.from_numpy(x))
        for served in (load_subnet(path, device="cpu"), load_subnet(blob, device="cpu")):
            got = served(torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), eager.numpy(), **SELF_TOL)
    jblob = jexport.export_subnet(jnet, p, s, jcfg, hw, batch=2, mode=mode, platforms=("cpu",))
    ref = np.asarray(jexport.load_subnet(jblob)(jnp.asarray(x)))
    if mode == "autoencoder":
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got.numpy(), ref, **JAX_TOL)


def test_served_subnet_holds_weights_as_buffers():
    """The traced program reads the folded tensors as the wrapper's buffers
    (copies with storage of their own), not as the supernet's parameters."""
    _, _, _, tnet = _nets("s4")
    subnet = get_active_subnet(tnet, uniform_subnet(tnet.space, 5, 3, 1, 1), use_kernels=False)
    served = ServedSubnet(subnet)
    n = sum(1 for _ in served.buffers())
    assert n > 0 and not list(served.parameters())
    ptrs = {b.untyped_storage().data_ptr() for b in served.buffers()}
    assert len(ptrs) == n
    assert not ptrs & {q.untyped_storage().data_ptr() for q in tnet.parameters()}


def test_export_fn_and_bad_input(tmp_path):
    """export_fn of a function closing over a tensor; load_subnet refuses
    what is neither a path nor bytes."""
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    blob = export_fn(lambda x: torch.relu(x @ w), (4, 3), device="cpu")
    x = torch.rand(4, 3)
    assert torch.equal(load_subnet(blob, device="cpu")(x), torch.relu(x @ w))
    with pytest.raises(TypeError):
        load_subnet(123, device="cpu")


@pytest.mark.parametrize("x4", [False, True])
def test_eval_cli_export(tmp_path, x4):
    """`eval_ofa_net_sr --export PATH` at full width: the artifact serves the
    default subnet (ks7/e6/d2/pixel_d 2; under --x4_autoencoder the
    decoder's sr-mode subnet, as the JAX CLI exports it) on the test
    frames' LR shape, equal to the eager plain path of the CLI's net."""
    art = str(tmp_path / "cli.pt2")
    flags = ["--x4_autoencoder"] if x4 else []
    argv = ["--synthetic", "--device", "cpu", "--dataset", "div2k", "--image_size", "16",
            "--path", str(tmp_path / "run"), "--export", art] + flags
    assert np.isfinite(teval.main(argv))
    with open(tmp_path / "run" / "logs" / "valid_console.txt") as f:
        assert "exported %s (%d bytes, input 4x4)" % (art, os.path.getsize(art)) in f.read()
    args = teval.build_args(argv)
    space = SearchSpace()
    net = (OFAMobileNetX4 if x4 else OFAMobileNetS4)(
        space, device="cpu", generator=torch.Generator().manual_seed(args.manual_seed))
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum, m.eps = args.bn_momentum, args.bn_eps
    cfg = uniform_subnet(space, 7, 6, 2, 2, n_trunks=net.n_trunks)
    x = torch.rand(1, 4, 4, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(load_subnet(art, device="cpu")(x).numpy(),
                                   get_active_subnet(net, cfg, use_kernels=False)(x).numpy(),
                                   **SELF_TOL)
