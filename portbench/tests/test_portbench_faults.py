"""The check has to fail a broken program. Each test drives a whole run of
a cell here on the CPU at a small size (the harness's look for a card
skipped), with the timed path broken underneath, and sees `correct` come
out false; and the control (the reference one precision below the
configuration's, in the program's place) fails the limits too.

Sizes: the S4 cells at batch 2 of 16 px patches, the classification cell
at batch 4 of 32 and 48 px images, the serving cell at 12 x 20 px frames.
"""

import json

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
SMALL = {
    "sr_train": {"batch": 2, "hr_size": 16, "window_steps": 2, "batch_pool": 4},
    "cls_train": {"batch": 4, "image_sizes": [32, 48], "window_steps": 2, "batch_pool": 2},
    "sr_serve": {"lr_h": 12, "lr_w": 20, "frame_pool": 3},
}


def cells_of(kinds):
    out = []
    for w in BENCH["workloads"]:
        if harness.traffic_of(w)["kind"] in kinds:
            out.append(w["name"])
    return out


def workload(cell_name, seed=2147483901):
    cell = harness.cell_entry(BENCH, cell_name)
    _, cfg = harness.config_of(BENCH, cell)
    traffic = harness.traffic_of(cell)
    traffic.update(SMALL[traffic["kind"]])
    kind = harness.kind_module(traffic["kind"])
    return kind.Workload(cell, cfg, traffic, seed, "cpu"), harness.limits_of(cell)


def run(cell_name):
    """A whole run but the look for a card: set-up, a short window, the
    program freed, the check; returns `correct` and the checks."""
    work, limits = workload(cell_name)
    work.setup()
    work.window(0.05)
    work.release()
    checks = work.check(limits)
    return harness.judge(checks), checks


@pytest.mark.parametrize("cell", cells_of({"sr_train"}))
def test_sr_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    from ofa_sr_tpu_torch.train.optim import GatedOpt
    monkeypatch.setattr(GatedOpt, "update", lambda self, clip_grad_norm=None: self.grad.zero_())
    correct, checks = run(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", cells_of({"cls_train"}))
def test_cls_step_that_leaves_the_state_unchanged_fails(cell, monkeypatch):
    from ofa_sr_tpu_torch.train.optim import GatedOpt
    monkeypatch.setattr(GatedOpt, "update", lambda self, clip_grad_norm=None: self.grad.zero_())
    correct, checks = run(cell)
    assert not correct, checks


def _half(batch):
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}


@pytest.mark.parametrize("cell", cells_of({"sr_train"}))
def test_sr_step_on_half_the_batch_fails(cell, monkeypatch):
    from ofa_sr_tpu_torch.train.train_step import SRTrainer
    orig = SRTrainer._subnet_loss
    monkeypatch.setattr(SRTrainer, "_subnet_loss",
                        lambda self, batch, cfg, t: orig(self, _half(batch), cfg, t))
    correct, checks = run(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", cells_of({"cls_train"}))
def test_cls_step_on_half_the_batch_fails(cell, monkeypatch):
    from ofa_sr_tpu_torch.train.cls_trainer import ClsTrainer
    orig = ClsTrainer._subnet_loss
    monkeypatch.setattr(ClsTrainer, "_subnet_loss",
                        lambda self, batch, arch, soft, masked=False: orig(
                            self, _half(batch), arch, None if soft is None
                            else soft[: soft.shape[0] // 2], masked))
    correct, checks = run(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", cells_of({"sr_serve"}))
def test_served_frame_altered_where_it_is_produced_fails(cell, monkeypatch):
    from ofa_sr_tpu_torch.models.materialize import StaticSubnet
    orig = StaticSubnet.__call__

    def altered(self, x, row_valid=None):
        y = orig(self, x, row_valid)
        y[0, 0, 0, 0] += 0.05
        return y

    monkeypatch.setattr(StaticSubnet, "__call__", altered)
    correct, checks = run(cell)
    assert not correct, checks


@pytest.mark.parametrize("cell", cells_of({"sr_train", "cls_train", "sr_serve"}))
def test_the_control_fails_the_limits(cell):
    work, limits = workload(cell)
    work.setup()
    if hasattr(work, "answer_all"):
        work.answer_all()
    work.release()
    control = work.control()
    assert not harness.judge([(n, v, limits[n]) for n, v in control if n in limits]), \
        json.dumps(control)
