"""The merge's share of its roofline, in %: the least time the card could
take for the merge's work (benchmark/counts/merge.py, counted from the
shapes) over the device time of the merge stage."""

import importlib.util
import os

from benchmark.peaks import least_seconds

_spec = importlib.util.spec_from_file_location(
    "benchmark_stage_ms_merge", os.path.join(os.path.dirname(__file__), "stage_ms.merge.py"))
_stage = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_stage)
SPANS = _stage.SPANS


def read(view):
    from benchmark.counts.merge import merge_work
    ms = _stage.read(view)
    if not ms:
        return None
    tree = view.cell["config"]["config"]
    den = tree["accumulated_robustness_denoiser"]["merge"]
    sh = view.shape
    nbytes, flops = merge_work(sh["frames"], sh["height"], sh["width"], float(tree["scale"]),
                               sh["tile_size"], int(den["rad_max"]), bool(den["enabled"]))
    return 100.0 * 1e3 * least_seconds(nbytes, flops) / ms
