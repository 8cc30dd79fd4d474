"""The SR curriculum through the port's CLIs (counterpart of the JAX half of
exp/curriculum.py).

Trains on a generated PNG tree (`gen_tree`): the 2x teacher
(`cli.train_teacher_net_sr_simple`, BN frozen, the reference teacher), then
the X4 supernet task by task through `cli.train_ofa_net_sr_simple`:
pretrain (the max net, the kernel task's warm start) -> kernel -> depth ->
expand -> pixelshuffle_depth, each warm-started from the previous task's
checkpoint, on the architectures the reference executes
(`--reference_quirks`). After each phase its validation grid (each
dimension's min and max corner) is scored by the port's
`SRRunManager.validate`; the report puts them beside PIL bicubic's PSNR-Y
on the same frames, and its headline gives the teacher's x2 margin and the
best x4 corner's margin over bicubic (`merge_curriculum_reports.headline`).

A cut run resumes: every finished phase is written to
`<out>/report_partial_port.json` and marked by `PHASE_DONE.json` in its
directory (the teacher's too, though its resume needs no checkpoint); a
rerun (or `--resume_report` naming an earlier report) takes a
phase's numbers instead of training it when the report's config matches
the run's on the keys that phase depends on and, for the supernet phases,
its finished checkpoint is still on disk.

Differences from the JAX script:
- Inits. The teacher and the supernet start from the port's own
  `OFAMobileNetS4` / `OFAMobileNetX4` drawn from `--seed`, written as port
  checkpoints that `--warmstart` reads. The JAX script draws both from the
  torch reference's modules (`make_torch_inits`), which need the reference
  source tree.
- Not ported: the torch-oracle half (`run_torch_curriculum`,
  `--skip_torch`, `--torch_resume_report`) and `--compile_cache` (XLA
  only). `--jax_resume_report` is `--resume_report`.

Run: python -m ofa_sr_tpu_torch.exp.curriculum --out DIR [--device cpu]
Writes DIR/report.json: config, baseline_bicubic, port (per-phase corner
PSNR-Y), port_sec, device_name and headline.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..cli import train_ofa_net_sr_simple, train_teacher_net_sr_simple
from ..cli.train_ofa_net_sr_simple import TASK_PHASES
from ..data import Div2KSetXXProvider
from ..models import OFAMobileNetS4, OFAMobileNetX4, SearchSpace
from ..models.arch import reference_quirk_arch_x4, uniform_subnet
from ..train import RunConfig, SRRunManager
from ..train.checkpoint import save_checkpoint
from ..train.shrink import corner_name
from ..utils.device import device_name, resolve_device
from ..utils.metrics import psnr_y_device
from .merge_curriculum_reports import headline

SEED = 0  # the image tree's seed, shared by every --seed
INIT_SEED = 42
SIDE = "port"
TEACHER_SPACE = dict(ks_list=[5], expand_list=[3], depth_list=[2], pixel_d_list=[1])
PRETRAIN_SPACE = dict(ks_list=[7], expand_list=[6], depth_list=[4], pixel_d_list=[2])


# ---------------------------------------------------------------------------
# synthetic image tree (SR-learnable: smooth textures + hard edges)
# ---------------------------------------------------------------------------

def gen_tree(root, n_train=32, n_val=4, size=64, seed=0, style="lowpass"):
    """`<root>/train` and `<root>/val` PNG trees in one of two styles:

    'lowpass': tiny noise bicubically upscaled + 4 thin edges. Nearly the
    best case for bicubic: the HR content below the edges is bicubic-
    upscaled low-pass noise, so bicubic x2 rebuilds it almost perfectly and
    the only learnable margin is a handful of random strokes.

    'sharp': dense piecewise-constant structure (filled shapes, strokes,
    text glyphs, checker patches at several scales), the content where SR
    beats interpolation: bicubic blurs every edge, a trained net re-sharpens
    them from learned priors.
    """
    from PIL import Image, ImageDraw
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            # low-pass texture: tiny noise bicubically upscaled
            base = rng.rand(size // 8, size // 8, 3) * 255
            img = Image.fromarray(base.astype(np.uint8)).resize(
                (size, size), Image.BICUBIC)
            draw = ImageDraw.Draw(img)
            if style == "lowpass":
                n_shapes = 4
            else:
                n_shapes = 24 + rng.randint(0, 16)
            for _ in range(n_shapes):
                x0, y0 = rng.randint(0, size - 8, 2)
                w, h = rng.randint(4, size // 2, 2)
                col = tuple(int(c) for c in rng.randint(0, 255, 3))
                x1, y1 = min(x0 + w, size - 1), min(y0 + h, size - 1)
                kind = rng.rand()
                if style == "lowpass":
                    if kind < 0.5:
                        draw.rectangle([x0, y0, x1, y1], outline=col,
                                       width=rng.randint(1, 3))
                    else:
                        draw.line([x0, y0, x1, y1], fill=col,
                                  width=rng.randint(1, 3))
                    continue
                if kind < 0.25:    # filled rectangle (hard edges, flat fill)
                    draw.rectangle([x0, y0, x1, y1], fill=col)
                elif kind < 0.45:  # filled ellipse (curved hard edge)
                    draw.ellipse([x0, y0, x1, y1], fill=col)
                elif kind < 0.65:  # stroke
                    draw.line([x0, y0, x1, y1], fill=col,
                              width=rng.randint(1, 3))
                elif kind < 0.85:  # text glyphs (natural SR content)
                    txt = "".join(chr(rng.randint(33, 126))
                                  for _ in range(rng.randint(2, 6)))
                    draw.text((x0, y0), txt, fill=col)
                else:              # checker patch (maximal high frequency)
                    c = int(rng.randint(2, 5))
                    for yy in range(y0, y1, c):
                        for xx in range(x0 + ((yy - y0) // c % 2) * c,
                                        x1, 2 * c):
                            draw.rectangle(
                                [xx, yy, min(xx + c - 1, x1),
                                 min(yy + c - 1, y1)], fill=col)
            img.save(os.path.join(d, "img_%04d.png" % i))


# ---------------------------------------------------------------------------
# the schedule and its validation grids
# ---------------------------------------------------------------------------

def phase_table(a):
    """The supernet phases, scaled: the space lists come from the CLI's own
    TASK_PHASES, the epochs and LR from the run's flags. Phase 2 of depth
    and expand walks both shrink stages in one invocation (the stage
    machine); the pixelshuffle phase pins k7/e6/d4 like the reference."""
    out = []
    for task, phase, dyn_bs in (("kernel", 1, 1), ("depth", 2, 2),
                                ("expand", 2, 2),
                                ("pixelshuffle_depth", 1, 1)):
        if a.sandwich:
            # the sandwich anchor needs at least one random sample next to
            # it: phases the reference runs at dynamic_batch_size=1 train 2
            # subnets a step here
            dyn_bs = max(2, dyn_bs)
        preset = TASK_PHASES[(task, phase)]
        out.append((task, dict(
            phase=phase,
            ks_list=preset["ks_list"], expand_list=preset["expand_list"],
            depth_list=preset["depth_list"],
            pixel_d_list=preset["pixel_d_list"],
            n_epochs=a.phase_epochs, base_lr=a.phase_lr,
            dynamic_batch_size=dyn_bs)))
    return out


def grid_corners(spec):
    """(ks, e, d, pixel_d) of each dimension's min and max, every pixel_d."""
    mm = lambda v: sorted({min(v), max(v)})  # noqa: E731
    out = []
    for pd in sorted(spec["pixel_d_list"]):
        for d in mm(spec["depth_list"]):
            for e in mm(spec["expand_list"]):
                for k in mm(spec["ks_list"]):
                    out.append((k, e, d, pd))
    return out


# ---------------------------------------------------------------------------
# the CLIs' arguments and the inits
# ---------------------------------------------------------------------------

def port_common(a):
    """The arguments every CLI call gets. `--gate_frequency` > 0 turns on
    periodic validation (and with it per-corner gating in the shrink
    phases); otherwise a phase validates once, after it ends."""
    gf = a.gate_frequency
    return ["--data_root", a.data_root, "--image_size", str(a.crop),
            "--base_batch_size", str(a.bs), "--n_worker", "2",
            "--manual_seed", str(a.seed),
            "--print_frequency", "1000",
            "--validation_frequency", str(gf if gf > 0 else 1000000),
            "--save_frequency", "20",
            "--clip_grad_norm", str(a.clip_grad_norm),
            "--device", a.device]


def make_port_inits(seed=0):
    """The teacher's and the supernet's init state_dicts: the port's nets
    drawn from `seed` (which offsets the draw, as in the JAX script: the
    subnet sampling contract does not depend on it)."""
    teacher = OFAMobileNetS4(SearchSpace(**TEACHER_SPACE), device="cpu",
                             generator=torch.Generator().manual_seed(INIT_SEED + 1000 * seed))
    supernet = OFAMobileNetX4(SearchSpace(), device="cpu",
                              generator=torch.Generator().manual_seed(
                                  INIT_SEED + 1000 * seed + 1))
    return {"teacher": teacher.state_dict(), "supernet": supernet.state_dict()}


def save_init_checkpoint(state_dict, out_dir):
    """An init as a port checkpoint (`latest.txt` and {"model"}), what the
    CLIs' `--warmstart` reads."""
    save_checkpoint(out_dir, {"epoch": -1, "best_acc": -1e9, "model": state_dict})
    return out_dir


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

# config keys a phase's numbers depend on: a resume report whose config
# differs on a phase's keys does not donate that phase's numbers. A key
# absent from an older report compares against the flag's default.
_DATA_KEYS = ("n_train", "n_val", "img", "crop", "bs", "style",
              "clip_grad_norm", "seed")
_PHASE_CONFIG_KEYS = {
    "teacher": _DATA_KEYS + ("teacher_epochs", "teacher_lr"),
    "pretrain": _DATA_KEYS + ("pretrain_epochs", "pretrain_lr"),
}
_SHRINK_KEYS = _DATA_KEYS + ("pretrain_epochs", "pretrain_lr",
                             "phase_epochs", "phase_lr", "kd_ratio",
                             "sandwich", "gate_frequency")
for _t in ("kernel", "depth", "expand", "pixelshuffle_depth"):
    _PHASE_CONFIG_KEYS[_t] = _SHRINK_KEYS


def write_partial(a, results, baseline):
    """Write the finished phases to <out>/report_partial_port.json after
    every phase, shaped like a finished report, so a cut run keeps what it
    reached; mirrored to --mirror_dir."""
    partial = {"config": vars(a), "baseline_bicubic": baseline,
               SIDE: dict(results), "partial": True}
    path = os.path.join(a.out, "report_partial_%s.json" % SIDE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(partial, f, indent=2)
    os.replace(tmp, path)
    _mirror(a, path)


def _mirror(a, path):
    """Copy a freshly written report into --mirror_dir as
    <out-basename>_<report-name>, so a wiped --out keeps its reports."""
    d = a.mirror_dir
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        dst = os.path.join(d, "%s_%s" % (
            os.path.basename(os.path.normpath(a.out)),
            os.path.basename(path)))
        tmp = dst + ".tmp"
        with open(path) as src, open(tmp, "w") as out:
            out.write(src.read())
        os.replace(tmp, dst)
    except OSError as e:  # the mirror is a second copy, never a blocker
        print("mirror to %s failed: %s" % (d, e), flush=True)


def _resumable_results(a):
    """Phases whose numbers are already known: from --resume_report and
    from this out-dir's own partial report (which wins). A phase is donated
    only when the report's config matches the run's on every key the phase
    depends on (_PHASE_CONFIG_KEYS). The caller skips a donated phase when
    retraining it is not needed for the warm-start chain: the teacher
    always (it is not on the chain), a supernet phase when its finished
    checkpoint (`_phase_complete`) is still on disk."""
    defaults = vars(build_parser().parse_args([]))
    done = {}
    for path in (a.resume_report,
                 os.path.join(a.out, "report_partial_%s.json" % SIDE)):
        if not path or not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                rep = json.load(f)
        except (OSError, ValueError) as e:
            print("resume report %s unreadable: %s" % (path, e), flush=True)
            continue
        cfg = rep.get("config") or {}
        for task, numbers in (rep.get(SIDE) or {}).items():
            bad = [k for k in _PHASE_CONFIG_KEYS.get(task, _SHRINK_KEYS)
                   if cfg.get(k, defaults.get(k)) != getattr(a, k)]
            if bad:
                print("%s %s in %s NOT resumable: config differs on %s"
                      % (SIDE, task, path,
                         {k: (cfg.get(k, defaults.get(k)), getattr(a, k)) for k in bad}),
                      flush=True)
                continue
            done[task] = numbers
    return done


def _phase_complete(path):
    """True iff the phase at <path> finished training and its grid eval ran
    (PHASE_DONE.json is written after the eval). The run manager makes the
    checkpoint directory before any save, so the directory alone proves
    nothing."""
    return (os.path.exists(os.path.join(path, "checkpoint", "latest.txt"))
            and os.path.exists(os.path.join(path, "PHASE_DONE.json")))


def _mark_phase_complete(path, task, results):
    with open(os.path.join(path, "PHASE_DONE.json"), "w") as f:
        json.dump({"task": task, "results": results}, f)


# ---------------------------------------------------------------------------
# the curriculum
# ---------------------------------------------------------------------------

def run_port_curriculum(a, inits, baseline):
    """Train the phases through the CLIs under <out>/port/<task>, each
    scored by `grid_eval`; returns {phase: {corner: PSNR-Y}}. `inits`:
    {"teacher", "supernet"} state_dicts; `baseline`: the bicubic floor
    written into the partial reports."""
    results = {}
    done = _resumable_results(a)
    # ---- teacher (S4 2x, BN frozen: the reference teacher) ----------------
    if "teacher" in done:
        print("port teacher: resumed from report (%s)" % done["teacher"], flush=True)
        results["teacher"] = done["teacher"]
    else:
        t_init = save_init_checkpoint(inits["teacher"], os.path.join(a.out, "init_teacher"))
        t_path = os.path.join(a.out, SIDE, "teacher")
        train_teacher_net_sr_simple.main(
            port_common(a) + ["--path", t_path, "--n_epochs", str(a.teacher_epochs),
                              "--base_lr", str(a.teacher_lr),
                              "--warmup_epochs", "0", "--warmstart", t_init])
        results["teacher"] = grid_eval(a, "teacher", t_path)
        _mark_phase_complete(t_path, "teacher", results["teacher"])
    write_partial(a, results, baseline)
    if a.teacher_only:
        return results

    # ---- supernet phases, warm-start chained ------------------------------
    prev = save_init_checkpoint(inits["supernet"], os.path.join(a.out, "init_supernet"))
    pretrain_ckpt = None
    if a.pretrain_epochs:
        # the max-net pretrain: the reference's kernel-phase warm start
        path = os.path.join(a.out, SIDE, "pretrain")
        if "pretrain" in done and _phase_complete(path):
            print("port pretrain: resumed from report", flush=True)
            results["pretrain"] = done["pretrain"]
        else:
            train_ofa_net_sr_simple.main(port_common(a) + [
                "--task", "pretrain", "--phase", "1", "--path", path,
                "--warmstart", prev, "--reference_quirks",
                "--n_epochs", str(a.pretrain_epochs),
                "--base_lr", str(a.pretrain_lr), "--warmup_epochs", "0",
                "--dynamic_batch_size", "1"])
            results["pretrain"] = grid_eval(a, "pretrain", path)
            _mark_phase_complete(path, "pretrain", results["pretrain"])
        write_partial(a, results, baseline)
        prev = pretrain_ckpt = os.path.join(path, "checkpoint")
    for task, spec in phase_table(a):
        path = os.path.join(a.out, SIDE, task)
        if task in done and _phase_complete(path):
            print("port %s: resumed from report" % task, flush=True)
            results[task] = done[task]
        else:
            argv = port_common(a) + [
                "--task", task, "--phase", str(spec["phase"]), "--path", path,
                "--warmstart", prev, "--reference_quirks",
                "--n_epochs", str(spec["n_epochs"]),
                "--base_lr", str(spec["base_lr"]), "--warmup_epochs", "0",
                "--dynamic_batch_size", str(spec["dynamic_batch_size"])]
            if a.kd_ratio > 0:
                # KD from the trained max net
                argv += ["--kd_ratio", str(a.kd_ratio), "--kd_teacher", pretrain_ckpt]
            if a.sandwich:
                argv += ["--sandwich"]
            if a.gate_frequency > 0:
                argv += ["--corner_gate"]
            train_ofa_net_sr_simple.main(argv)
            results[task] = grid_eval(a, task, path)
            _mark_phase_complete(path, task, results[task])
        write_partial(a, results, baseline)
        prev = os.path.join(path, "checkpoint")
    return results


def _provider(a):
    return Div2KSetXXProvider(root=a.data_root, image_size=a.crop,
                              train_batch_size=a.bs, num_workers=2)


def grid_eval(a, task, path):
    """Validation-grid PSNR-Y of a finished phase, on the phase's own space
    and the architectures the phase trained (`reference_quirk_arch_x4` for
    the X4 phases). A corner with a gated snapshot (`best_<corner>.pth.tar`,
    `--gate_frequency`) is scored from that snapshot. Raises ValueError when
    a checkpoint leaves a tensor of the phase's net at its init."""
    dev = resolve_device(a.device)
    if task == "teacher":
        space = SearchSpace(**TEACHER_SPACE)
        net = OFAMobileNetS4(space, device=dev)
        corners = [(5, 3, 2, 1)]
    else:
        spec = PRETRAIN_SPACE if task == "pretrain" else dict(phase_table(a))[task]
        # the phase's own space: its checkpoint may lack what a larger
        # space has (e.g. the kernel-transform matrices)
        space = SearchSpace(**{k: spec[k] for k in PRETRAIN_SPACE})
        net = OFAMobileNetX4(space, device=dev)
        corners = grid_corners(spec)
    rm = SRRunManager(os.path.join(a.out, SIDE + "_eval", task), net,
                      RunConfig(image_size=a.crop, manual_seed=a.seed), _provider(a))

    def load(src):
        # the phase's own checkpoint fills its own space: a tensor left at
        # its init would be scored as trained
        if rm.load_weights(src)["kept_template"]:
            raise ValueError("%s does not hold every tensor of the %s phase's net" % (src, task))

    ckpt_dir = os.path.join(path, "checkpoint")
    load(ckpt_dir)
    base_loaded = True
    out = {}
    for (k, e, d, pd) in corners:
        name = corner_name(pd, d, e, k)
        best_f = os.path.join(ckpt_dir, "best_%s.pth.tar" % name)
        if os.path.exists(best_f):
            load(best_f)
            base_loaded = False
        elif not base_loaded:
            load(ckpt_dir)
            base_loaded = True
        cfg = uniform_subnet(space, k, e, d, pd, n_trunks=net.n_trunks)
        if task != "teacher":
            cfg = reference_quirk_arch_x4(cfg)
        out[name] = round(rm.validate(cfg)[1], 3)
    return out


def bicubic_baseline(a):
    """PSNR-Y of PIL bicubic upscaling on the val frames, x2 and x4: the
    floor a trained SR net must clear."""
    from PIL import Image
    dev = resolve_device(a.device)
    out = {}
    for pd in (1, 2):
        psnrs = []
        for b in _provider(a).test:
            lr = np.asarray(b["x%d" % (2 ** pd)])[0]
            hr = np.asarray(b["image"])[0]
            up = Image.fromarray(
                (np.clip(lr, 0, 1) * 255).round().astype(np.uint8)).resize(
                (hr.shape[1], hr.shape[0]), Image.BICUBIC)
            up = np.asarray(up).astype(np.float32) / 255.0
            psnrs.append(float(psnr_y_device(torch.from_numpy(up[None]).to(dev),
                                             torch.from_numpy(hr[None]).to(dev))))
        out["x%d" % (2 ** pd)] = round(float(np.mean(psnrs)), 3)
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(), "ofa_curriculum"))
    ap.add_argument("--data_root", type=str, default=None,
                    help="the PNG tree (default <out>/data, generated if missing)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: the card by default, or 'cpu'")
    ap.add_argument("--n_train", type=int, default=32)
    ap.add_argument("--n_val", type=int, default=4)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--crop", type=int, default=32)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--teacher_epochs", type=int, default=12)
    ap.add_argument("--teacher_lr", type=float, default=1e-3)
    ap.add_argument("--pretrain_epochs", type=int, default=0,
                    help="X4 max-net pretraining epochs before the kernel phase (the "
                         "reference's normal2pixelshuffle warm start); 0: the phases start "
                         "from the init")
    ap.add_argument("--pretrain_lr", type=float, default=1e-3)
    ap.add_argument("--clip_grad_norm", type=float, default=0.0,
                    help="global-norm gradient clipping (0 = off, the reference); a guard "
                         "for long frozen-BN teacher schedules")
    ap.add_argument("--phase_epochs", type=int, default=4)
    ap.add_argument("--phase_lr", type=float, default=2.5e-4)
    ap.add_argument("--kd_ratio", type=float, default=0.0,
                    help="KD from the finished pretrain max net in the shrink phases; needs "
                         "--pretrain_epochs > 0")
    ap.add_argument("--sandwich", action="store_true",
                    help="sandwich rule in the shrink phases: subnet k=0 of every step is "
                         "the phase's max corner; phases the reference runs at "
                         "dynamic_batch_size=1 train 2 subnets a step")
    ap.add_argument("--gate_frequency", type=int, default=0,
                    help="validate the stage grid every N epochs in the shrink phases and "
                         "snapshot each corner's best weights, which the phase's result "
                         "then scores; 0: one validation after each phase")
    ap.add_argument("--teacher_only", action="store_true",
                    help="train and score the 2x teacher, then stop")
    ap.add_argument("--seed", type=int, default=0,
                    help="init and shuffle seed; the image tree stays at the shared seed, "
                         "so every seed trains on the same images")
    ap.add_argument("--resume_report", type=str, default=None,
                    help="an earlier report whose phase numbers are taken instead of "
                         "training: the teacher whenever its config keys match, the "
                         "supernet phases only if their finished checkpoint "
                         "(PHASE_DONE.json) is still on disk")
    ap.add_argument("--mirror_dir", type=str, default=None,
                    help="directory to copy every report into as it is written, named "
                         "<out-basename>_<report-name>")
    ap.add_argument("--style", type=str, default="lowpass", choices=["lowpass", "sharp"],
                    help="the image tree's style (see gen_tree)")
    return ap


def main(argv=None):
    ap = build_parser()
    a = ap.parse_args(argv)
    if a.kd_ratio > 0 and not a.pretrain_epochs:
        ap.error("--kd_ratio > 0 requires --pretrain_epochs > 0 (the pretrain max net is "
                 "the KD teacher)")
    name = device_name(a.device)  # no card and no --device cpu: raises here
    if a.data_root is None:
        a.data_root = os.path.join(a.out, "data")
    os.makedirs(a.out, exist_ok=True)
    if not os.path.exists(os.path.join(a.data_root, "train")):
        gen_tree(a.data_root, a.n_train, a.n_val, a.img, seed=SEED, style=a.style)

    report = {"config": vars(a), "baseline_bicubic": bicubic_baseline(a),
              "device_name": name}
    t0 = time.time()
    report[SIDE] = run_port_curriculum(a, make_port_inits(a.seed), report["baseline_bicubic"])
    report[SIDE + "_sec"] = round(time.time() - t0, 1)
    report["headline"] = headline(report, SIDE)
    path = os.path.join(a.out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    _mirror(a, path)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
