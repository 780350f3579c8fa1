"""Accuracy against ground truth: the port's numpy copies of the synthetic
bursts (``io/synthetic.py``) and metrics (``utils/metrics.py``) against the
JAX package's, ``hmsr_tpu_torch.score_accuracy`` on the CPU against
``tools/score_accuracy.py``'s JAX scoring of the same small bursts (scan),
and the port's fused form against the JAX package's record
``ACCURACY_r05.json``, which was scored through its fused form.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hmsr_tpu.io import synthetic as j_syn  # noqa: E402
from hmsr_tpu.utils import metrics as j_metrics  # noqa: E402
from hmsr_tpu_torch import score_accuracy  # noqa: E402
from hmsr_tpu_torch.io import synthetic as syn  # noqa: E402
from hmsr_tpu_torch.utils import metrics  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA, BETA = score_accuracy.ALPHA, score_accuracy.BETA


def _jax_tool():
    """``tools/score_accuracy.py`` as a module (its helpers and its JAX
    pipeline call)."""
    spec = importlib.util.spec_from_file_location(
        "jax_score_accuracy", os.path.join(ROOT, "tools", "score_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("maker,kw", [
    ("make_synthetic_burst", {}),
    ("make_synthetic_burst", {"grey": True, "seed": 3}),
    ("make_synthetic_burst", {"sr_factor": 3, "max_shift": 1.0, "seed": 9}),
    ("make_occlusion_burst", {}),
    ("make_occlusion_burst", {"velocity": (1.0, -2.0), "object_radius": 6.0, "seed": 4}),
])
def test_bursts_bit_identical(maker, kw):
    """Frames, truth and shifts (or ghost mask) equal the JAX package's bit
    for bit."""
    _same(getattr(syn, maker)(48, 64, 4, **kw), getattr(j_syn, maker)(48, 64, 4, **kw))


def test_synthetic_helpers_bit_identical():
    rgb = syn.smooth_rgb(40, 56, seed=2)
    _same(rgb, j_syn.smooth_rgb(40, 56, seed=2))
    _same(syn.spectral_shift(rgb, 0.7, -1.3), j_syn.spectral_shift(rgb, 0.7, -1.3))
    _same(syn.spectral_shift(rgb[..., 0], 2.5, 0.25),
          j_syn.spectral_shift(rgb[..., 0], 2.5, 0.25))
    _same(syn.mosaic(rgb), j_syn.mosaic(rgb))
    _same(syn.area_downsample(rgb, 2), j_syn.area_downsample(rgb, 2))
    _same(syn.area_downsample(rgb[..., 1], 3), j_syn.area_downsample(rgb[..., 1], 3))


def test_metrics_equal():
    """RMSE and PSNR equal the JAX package's on numpy inputs and on
    tensors; PSNR is inf on equal images and None on different shapes."""
    rng = np.random.RandomState(0)
    a = rng.rand(32, 48, 3).astype(np.float32)
    b = np.clip(a + 0.01 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    assert metrics.compute_rmse(a, b) == j_metrics.compute_rmse(a, b)
    assert metrics.compute_psnr(a, b) == j_metrics.compute_psnr(a, b)
    assert metrics.compute_psnr(a, b, 2.0) == j_metrics.compute_psnr(a, b, 2.0)
    assert metrics.compute_psnr(torch.as_tensor(a), torch.as_tensor(b)) == \
        j_metrics.compute_psnr(a, b)
    assert metrics.compute_psnr(a, a) == float("inf")
    assert metrics.compute_psnr(a, a[:, :40]) is None


def test_score_truth_against_jax():
    """``psnr_vs_truth_db`` on the CPU on a 256^2 4-frame burst (seed 7),
    within 0.01 dB of the JAX tool's score of the same burst (its scan
    pipeline)."""
    tool = _jax_tool()
    size, frames = 256, 4
    got = score_accuracy.score_truth(size, frames, "cpu")
    ref, comps, truth, _ = j_syn.make_synthetic_burst(size, size, n_frames=frames,
                                                      alpha=ALPHA, beta=BETA, seed=7,
                                                      max_shift=2.0)
    config = tool.build_config(size, size, ALPHA, BETA)
    config.tpu.pipeline = "scan"
    std, diff = tool.flat_curves(ALPHA, BETA)
    img = tool.run_jax_pipeline(ref, comps, config, j_syn.DEFAULT_CFA, [1.0] * 3, std, diff)
    crop = 2 * int(config.block_matching.tuning.tile_size)
    inner = np.s_[crop:-crop, crop:-crop]
    want = tool.psnr(np.nan_to_num(img[inner], nan=0.0), truth[inner])
    assert got["crop_px"] == crop == 32
    assert abs(got["psnr_db"] - want) <= 0.01, (got["psnr_db"], want)
    assert got["psnr_db"] > 30


def test_score_robustness_against_jax():
    """The robustness-value scores on the CPU on the JAX record's burst
    (384^2, 12 frames, seed 21), each within 0.01 dB of the JAX tool's
    scores of the same burst through its scan pipeline; robustness raises
    the ghost region's PSNR. (``ACCURACY_r05.json`` was scored through the
    JAX package's CPU default, the ``fused`` slab pipeline, whose per-slab
    refill also fills interior pixels that no compared frame reached: with
    robustness on it scores the ghost region higher than the scan
    pipeline, which the port follows.) The JAX scores equal those of the
    committed scan record ``ACCURACY_JAX_SCAN.json`` within its rounding
    (3 decimals)."""
    tool = _jax_tool()
    size, frames = 384, 12
    with open(os.path.join(ROOT, "ACCURACY_JAX_SCAN.json")) as f:
        record = json.load(f)["robustness_value"]
    got = score_accuracy.score_robustness(size, frames, "cpu")
    ref, comps, truth, ghost = j_syn.make_occlusion_burst(
        size, size, n_frames=frames, alpha=ALPHA, beta=BETA, seed=21, max_shift=2.0)
    std, diff = tool.flat_curves(ALPHA, BETA)
    for label, enabled in (("on", True), ("off", False)):
        c = tool.build_config(size, size, ALPHA, BETA)
        c.tpu.pipeline = "scan"
        c.robustness.enabled = enabled
        if not enabled:
            c.robustness.save_mask = False
        img = np.nan_to_num(tool.run_jax_pipeline(ref, comps, c, j_syn.DEFAULT_CFA,
                                                  [1.0] * 3, std, diff), nan=0.0)
        crop = 2 * int(c.block_matching.tuning.tile_size)
        inner = np.zeros(ghost.shape, bool)
        inner[crop:-crop, crop:-crop] = True
        for region, mask in (("ghost", inner & ghost), ("global", inner)):
            want = tool.psnr(img[mask], truth[mask])
            key = f"psnr_{region}_{label}_db"
            assert abs(got[key] - want) <= 0.01, (region, label)
            assert abs(record[key] - want) <= 1e-3, (key, record[key], want)
    assert got["psnr_ghost_on_db"] > got["psnr_ghost_off_db"] + 10


def test_score_robustness_fused_against_record():
    """The robustness-value scores of the port's ``fused`` form (the slab
    refill) on the CPU on the record's burst (384^2, 12 frames, seed 21),
    each within 0.01 dB of ``ACCURACY_r05.json``, which the JAX tool scored
    through its CPU default, the same form (``tests/score_jax_fused.py``
    reproduces it). With robustness on, the fused form's per-slab refill of
    the interior pixels that no compared frame reached scores the ghost
    region above the scan form's record ``ACCURACY_JAX_SCAN.json``."""
    with open(os.path.join(ROOT, "ACCURACY_r05.json")) as f:
        record = json.load(f)["robustness_value"]
    with open(os.path.join(ROOT, "ACCURACY_JAX_SCAN.json")) as f:
        scan = json.load(f)["robustness_value"]
    got = score_accuracy.score_robustness(384, 12, "cpu", pipeline="fused")
    for key in ("psnr_ghost_on_db", "psnr_global_on_db", "psnr_ghost_off_db",
                "psnr_global_off_db"):
        assert abs(got[key] - record[key]) <= 0.01, (key, got[key], record[key])
    assert got["psnr_ghost_on_db"] > scan["psnr_ghost_on_db"] + 0.3
