"""The benchmark's plain grey reference (``benchmark/reference/grey.py``)
against the port's grey mode on the fused form, on the CPU.

``process_arrays`` with the ``burst20_12mp_grey_x2`` tree (``tpu.pipeline:
auto``, which runs the fused form) on seeded bursts of the benchmark's
generator at small sizes, at x2 and x3, bright (16-px tiles) and dark
(32-px tiles); the reference's refusals, each naming the key; and the
readings that ``grey_x2_device``'s limits must reject: the reference in
bfloat16 (the control) and three faults of the timed entry.
"""

import copy
import re

import pytest

from benchmark import run as R
from benchmark.burst import make_burst, pool_seeds
from benchmark.compare import judge, readings
from benchmark.control import readings_for
from benchmark.reference.grey import reference_burst
from hmsr_tpu_torch.models import process as P
from hmsr_tpu_torch.models.pipeline import pipeline_form

CELL = "grey_x2_device"
SPEC = R.resolve(CELL)
CONF = SPEC["config"]
#: a burst whose pyramid holds a 16-px tile on every level
SMALL = (4, 256, 256)


def _tree(**dotted):
    """The cell's configuration tree with the dotted keys given set."""
    tree = copy.deepcopy(CONF["config"])
    for key, value in dotted.items():
        *head, last = key.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


@pytest.mark.parametrize("shape, scale, brightness, seed, tile", [
    ((8, 256, 256), 2, None, 2147483001, 16),
    ((8, 256, 256), 3, None, 2147483002, 16),
    # a height that is no multiple of the tile (as 3000 is not of 16): a
    # partial tile row, and padded accumulator rows
    ((8, 264, 328), 2, None, 2147483003, 16),
    ((8, 264, 328), 3, None, 2147483004, 16),
    ((8, 512, 512), 2, 0.07, 2147483005, 32),
])
def test_program_agrees_with_the_grey_reference(shape, scale, brightness, seed, tile):
    n, h, w = shape
    tree = _tree(scale=scale)
    frames = make_burst(h, w, n, seed, "cpu", CONF["noise"]["alpha"], CONF["noise"]["beta"],
                        brightness)
    cfg = R.program_config(tree)
    img, debug = P.process_arrays(frames[0], frames[1:], cfg, CONF["cfa"],
                                  CONF["white_balance"], device="cpu")
    assert cfg.block_matching.tuning.tile_size == tile and pipeline_form(cfg) == "fused"
    ref_img, ref_acc = reference_burst(frames, tree, CONF["cfa"], CONF["white_balance"])
    assert tuple(img.shape) == tuple(ref_img.shape) == (h * scale, w * scale, 3)
    got = readings(img, debug["accumulated_robustness"], ref_img, ref_acc)
    # the CPU runs the plain twins of the kernels: the two agree but for the
    # finishing blur's summation order (~5e-8)
    assert got["image_rel_rms"] < 1e-6 and got["accrob_rel_rms"] < 1e-6, got


@pytest.mark.parametrize("named, value", [
    ("mode", "bayer"),
    ("merging.kernel", "iso"),
    ("scale", 1.5),
    ("tpu.pipeline", "scan"),
    ("tpu.pipeline", "chunked"),
    ("tpu.pipeline", "vmapped"),
    ("tpu.merge_impl", "gather"),
    ("tpu.fused_impl", "tiled"),
    ("accumulated_robustness_denoiser.merge.enabled", True),
    ("accumulated_robustness_denoiser.median.enabled", True),
    ("accumulated_robustness_denoiser.gauss.enabled", True),
])
def test_grey_reference_refuses_what_it_does_not_implement(named, value):
    # refused before any work: the frames are never read
    with pytest.raises(ValueError, match=re.escape(named + "=")):
        reference_burst(None, _tree(**{named: value}), CONF["cfa"], CONF["white_balance"])


def test_lower_precision_control_is_not_correct():
    got = readings_for(CELL, 424242424242, device="cpu", shape=SMALL)
    ok, checks = judge(got["control"], SPEC["limits"])
    assert not ok, checks


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_faults_are_not_correct(kind):
    # the timed entry called on a pool of two bursts in turn, as a run's
    # window calls it, with a fault; the second call's answer is compared
    last = {}

    def broken(ref, comps, *a, **k):
        if kind == "half":              # half of the compared frames left out
            comps = comps[: len(comps) // 2]
        img, debug = P.process_arrays(ref, comps, *a, **k)
        if kind == "stale":             # the state of the previous call returned
            img, debug, last["out"] = (*last.get("out", (img, debug)), (img, debug))
        if kind == "altered":           # the answer altered where it is produced
            img = img * 1.01
        return img, debug

    n, h, w = SMALL
    pool = [make_burst(h, w, n, s, "cpu", CONF["noise"]["alpha"], CONF["noise"]["beta"])
            for s in pool_seeds(77777777777, 2)]
    for frames in pool:
        img, debug = broken(frames[0], frames[1:], R.program_config(CONF["config"]),
                            CONF["cfa"], CONF["white_balance"], device="cpu")
    ref = reference_burst(pool[-1], CONF["config"], CONF["cfa"], CONF["white_balance"])
    ok, checks = judge(readings(img, debug["accumulated_robustness"], *ref), SPEC["limits"])
    assert not ok, checks
