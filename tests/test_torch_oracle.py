"""The port's pipeline against the composed float64 scalar oracle of the
whole burst pipeline (``tests/oracles/numpy_pipeline.py``), on the CPU: the
oracle section of the JAX package's accuracy tool
(``tools/score_accuracy.py``), as ``tests/test_full_oracle.py`` holds the
JAX pipeline to it, with that test's inputs and tolerances.

The port does not import the oracle; only this test does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import ALPHA, BETA, WB, curves, kernel_counts, n  # noqa: E402

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.models.pipeline import make_pipeline  # noqa: E402
from oracles import numpy_pipeline  # noqa: E402

SIZE = 96


def oracle_config(iso):
    """``tests/test_full_oracle.py:oracle_config`` on the port's tree."""
    c = configs.default_config()
    c.scale = 2
    c.mode = "bayer"
    c.debug = True
    c.block_matching.tuning.update(tile_size=16, factors=[1, 2], tile_size_factors=[1, 1],
                                   search_radii=[1, 4], metrics=["L1", "L2"])
    c.merging.kernel = "iso" if iso else "steerable"
    c.merging.selection_law = "linear"
    c.robustness.save_mask = False
    c.accumulated_robustness_denoiser.enabled = False
    c.noise_model.alpha = ALPHA
    c.noise_model.beta = BETA
    configs.update_snr_config(c, 20)
    c.block_matching.tuning.tile_sizes = [16, 16]
    configs.sanitize_config(c, (SIZE, SIZE))
    c["tpu"] = {"pipeline": "scan"}     # the oracle refills the border strips
    return c


@pytest.mark.parametrize("iso", [False, True])
def test_pipeline_matches_composed_oracle(iso):
    """Flows within atol 1e-3 (rtol 1e-4), robustness within 2e-3, the image
    within 2e-3 with a mean error under 2e-5 where both are finite, and NaNs
    only on the 2-pixel frame (where float32 underflows a weight sum that
    float64 keeps)."""
    ref, comps, _, _ = make_synthetic_burst(SIZE, SIZE, n_frames=3, alpha=ALPHA,
                                            beta=BETA, seed=13, max_shift=1.5)
    c = oracle_config(iso)
    std, diff = curves()
    img, debug = make_pipeline(c, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    img = n(img)
    want_img, want_flows, want_r = numpy_pipeline.run_pipeline(
        ref, comps, std.astype(np.float64), diff.astype(np.float64), c, DEFAULT_CFA, WB)

    np.testing.assert_allclose(n(debug["flow"]), np.stack(want_flows), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(n(debug["robustness"]), np.stack(want_r), atol=2e-3)
    assert img.shape == want_img.shape
    finite = np.isfinite(img) & np.isfinite(want_img)
    inner = np.zeros_like(finite)
    inner[2:-2, 2:-2] = True
    assert finite[inner].all(), "NaNs off the border frame"
    np.testing.assert_allclose(img[finite], want_img[finite], atol=2e-3)
    assert np.mean(np.abs(img[finite] - want_img[finite])) < 2e-5
    assert kernel_counts() == (0,) * 8
