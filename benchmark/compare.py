"""The comparison that decides ``correct``: the image and the accumulated
robustness that the timed path returned, against the plain reference's.

Each number compared is a gap that grows with the fault it is meant to
catch; its limit comes from the cell's limits file
(``benchmark/limits/<workload>.json``), set between the largest reading of
sound runs and the smallest reading of the lower-precision control
(``PERF.md`` gives both). A shape that differs, or a value that is not
finite where the reference's is, reads ``inf``.
"""

import math

import torch


def _gaps(prog, ref):
    """(relative RMS gap, largest absolute gap) of ``prog`` against ``ref``,
    evaluated in float64 on ``ref``'s device."""
    if prog is None or tuple(prog.shape) != tuple(ref.shape):
        return math.inf, math.inf
    p = torch.as_tensor(prog).to(ref.device)
    r = ref
    finite = torch.isfinite(r)
    if not torch.equal(torch.isfinite(p), finite):
        return math.inf, math.inf
    d = (p[finite].double() - r[finite].double())
    rms_ref = float(torch.sqrt(torch.mean(r[finite].double() ** 2)))
    rel = float(torch.sqrt(torch.mean(d * d))) / max(rms_ref, 1e-30)
    return rel, float(d.abs().max()) if d.numel() else 0.0


def readings(image, acc_rob, ref_image, ref_acc_rob):
    """The numbers compared, by name."""
    rel_i, max_i = _gaps(image, ref_image)
    rel_a, max_a = _gaps(acc_rob, ref_acc_rob)
    return {"image_rel_rms": rel_i, "image_max_abs": max_i,
            "accrob_rel_rms": rel_a, "accrob_max_abs": max_a}


def judge(values, limits):
    """``(correct, checks)``: every limited number at or under its limit;
    ``checks`` maps each limited name to its reading and its limit."""
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
