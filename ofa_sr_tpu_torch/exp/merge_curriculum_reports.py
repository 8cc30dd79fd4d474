"""The curriculum's headline, and the join of a JAX half-report with a port
half-report (counterpart of exp/merge_curriculum_reports.py, with its
torch-oracle half read as the port's).

`headline(report, side)`: does the trained model beat bicubic? The
teacher's x2 PSNR-Y and its margin over bicubic, the best x4 (pixel_d 2)
corner over every supernet phase and its margin, and the last phase's best
x4 corner. `merge(jax_half, port_half)` checks that the halves describe
the same experiment (config, bicubic floor within 0.01 dB), puts both
sides' phases side by side with their deltas, and adds the JAX side's
headline with the deltas' mean and largest magnitude.

Run: python -m ofa_sr_tpu_torch.exp.merge_curriculum_reports JAX_REPORT PORT_REPORT [--out F]
"""

from __future__ import annotations

import argparse
import json

# config keys that may differ between the two halves
_SIDE_LOCAL = {"out", "skip_torch", "skip_jax", "compile_cache", "data_root",
               "jax_resume_report", "torch_resume_report", "resume_report",
               "mirror_dir", "device"}
_ORDER = ["pretrain", "kernel", "depth", "expand", "pixelshuffle_depth"]


def headline(report: dict, side: str, deltas=None) -> dict:
    """The trained-vs-bicubic margins of `report[side]`; `deltas`
    ({phase: {corner: dB}} against a second half) fill the two
    oracle_delta_* keys, which are None without it."""
    phases = report[side]
    bic = report["baseline_bicubic"]
    teacher = max(phases["teacher"].values())
    # the best 4x corner over all supernet phases: every phase checkpoint is
    # a trained supernet, and progressive shrinking can degrade the max
    # corner through later phases; the final phase's own best is reported
    # beside it
    x4 = {(ph, k): v for ph, corners in phases.items() if ph != "teacher"
          for k, v in corners.items() if k.endswith("PD2")}
    best = max(x4, key=x4.get) if x4 else None
    reached = [ph for ph in _ORDER if ph in phases]
    final_phase = reached[-1] if reached else "teacher"
    final_pd2 = {k: v for k, v in phases[final_phase].items() if k.endswith("PD2")}
    flat = [d for ph in (deltas or {}).values() for d in ph.values()]
    return {
        "teacher_psnr_x2": teacher,
        "bicubic_x2": bic["x2"],
        "teacher_margin_db": round(teacher - bic["x2"], 3),
        "best_corner": best[1] if best else None,
        "best_corner_phase": best[0] if best else None,
        "best_corner_psnr_x4": round(x4[best], 3) if best else None,
        "bicubic_x4": bic["x4"],
        "corner_margin_db": round(x4[best] - bic["x4"], 3) if best else None,
        "final_phase": final_phase,
        "final_phase_best_pd2_psnr": (round(max(final_pd2.values()), 3)
                                      if final_pd2 else None),
        "oracle_delta_mean_db": round(sum(flat) / len(flat), 3) if flat else None,
        "oracle_delta_max_abs_db": round(max(abs(d) for d in flat), 3) if flat else None,
    }


def merge(jr: dict, pr: dict) -> dict:
    """One report from a JAX half (`jr["jax"]`) and a port half
    (`pr["port"]`) of the same experiment."""
    for k in set(jr["config"]) | set(pr["config"]):
        if k in _SIDE_LOCAL:
            continue
        if jr["config"].get(k) != pr["config"].get(k):
            raise SystemExit("config mismatch on %r: jax=%r port=%r" %
                             (k, jr["config"].get(k), pr["config"].get(k)))
    # the same data gives the same bicubic PSNR up to the backends' float
    # accumulation: anything past 0.01 dB means other data
    for s in ("x2", "x4"):
        if abs(jr["baseline_bicubic"][s] - pr["baseline_bicubic"][s]) > 0.01:
            raise SystemExit("bicubic baselines differ: the halves did not see the same "
                             "data: %r vs %r" % (jr["baseline_bicubic"],
                                                 pr["baseline_bicubic"]))
    out = {"config": {k: v for k, v in jr["config"].items()
                      if k not in ("skip_torch", "skip_jax")},
           "baseline_bicubic": jr["baseline_bicubic"],
           "jax": jr["jax"], "jax_sec": jr.get("jax_sec"),
           "port": pr["port"], "port_sec": pr.get("port_sec")}
    if jr.get("partial") or pr.get("partial"):
        # a half cut mid-curriculum: join the phases both reached, list the
        # rest
        out["partial"] = True
        out["phases_missing_port"] = sorted(set(jr["jax"]) - set(pr["port"]))
        out["phases_missing_jax"] = sorted(set(pr["port"]) - set(jr["jax"]))
    deltas = {}
    for phase in out["jax"]:
        if phase not in out["port"]:
            if out.get("partial"):
                continue
            raise SystemExit("phase %r missing from the port half" % phase)
        deltas[phase] = {k: round(out["jax"][phase][k] - out["port"][phase][k], 3)
                         for k in out["jax"][phase]}
    out["delta_jax_minus_port"] = deltas
    out["headline"] = headline(out, "jax", deltas)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("jax_report")
    ap.add_argument("port_report")
    ap.add_argument("--out", type=str, default=None)
    a = ap.parse_args(argv)
    with open(a.jax_report) as f:
        jr = json.load(f)
    with open(a.port_report) as f:
        pr = json.load(f)
    merged = merge(jr, pr)
    text = json.dumps(merged, indent=2)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return merged


if __name__ == "__main__":
    main()
