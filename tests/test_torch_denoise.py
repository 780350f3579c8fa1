"""The frame-count denoisers (``finishing/denoise.py``) against the JAX
package's: the median exactly, the Gauss within 1e-5, at x2 and x1.5 (where
the HR pixels map onto the raw-resolution accumulated robustness at
``round(y / 1.5)``); and ``process_arrays`` with each of them (scan, device
finishing) against the JAX package's ``process_arrays``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import kernel_counts, max_abs, n, t  # noqa: E402
from test_torch_process import _check_finishing, jax_config, port_config  # noqa: E402

from hmsr_tpu.finishing import denoise as j_denoise  # noqa: E402
from hmsr_tpu.io.synthetic import make_synthetic_burst  # noqa: E402
from hmsr_tpu.models.process import process_arrays as j_process_arrays  # noqa: E402
from hmsr_tpu_torch.finishing import denoise  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402

H, W = 36, 44


def _inputs(scale, seed):
    """An image at ``round(scale * (H, W))`` and an accumulated robustness
    over [0, 10] on the raw grid: pixels under, at and over the frame
    count 8 (which clips it), so that every radius and sigma 0 occur."""
    rng = np.random.RandomState(seed)
    img = rng.rand(round(scale * H), round(scale * W), 3).astype(np.float32)
    acc = rng.uniform(0, 10, (H, W)).astype(np.float32)
    acc[::5] = 8.0
    acc[1::7] = 0.0
    return img, acc


@pytest.mark.parametrize("scale", [2, 1.5])
def test_acc_r_lookup(scale):
    _, acc = _inputs(scale, 0)
    out = (round(scale * H), round(scale * W))
    np.testing.assert_array_equal(n(denoise._acc_r_lookup(t(acc), out, scale)),
                                  np.asarray(j_denoise._acc_r_lookup(jnp.asarray(acc),
                                                                     out, scale)))


@pytest.mark.parametrize("scale", [2, 1.5])
@pytest.mark.parametrize("radius_max", [3, 5])
def test_median_against_jax(scale, radius_max):
    """Exactly JAX's values; bands of a few rows (the tap-stack budget
    lowered) give the same image."""
    img, acc = _inputs(scale, 1)
    cfg = {"radius_max": radius_max, "max_frame_count": 8, "scale": scale}
    want = j_denoise.frame_count_denoising_median(img, jnp.asarray(acc), cfg)
    got = denoise.frame_count_denoising_median(t(img), t(acc), cfg)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    budget = denoise.MEDIAN_STACK_BYTES
    try:
        denoise.MEDIAN_STACK_BYTES = (2 * radius_max + 1) ** 2 * img.shape[1] * 3 * 4 * 5
        banded = denoise.frame_count_denoising_median(t(img), t(acc), cfg)
    finally:
        denoise.MEDIAN_STACK_BYTES = budget
    assert torch.equal(banded, got)


@pytest.mark.parametrize("scale", [2, 1.5])
@pytest.mark.parametrize("sigma_max", [1.5, 1.0])
def test_gauss_against_jax(scale, sigma_max):
    """Within 1e-5 of JAX's values, in bands of 16 rows."""
    img, acc = _inputs(scale, 2)
    cfg = {"sigma_max": sigma_max, "max_frame_count": 8, "scale": scale}
    want = j_denoise.frame_count_denoising_gauss(img, jnp.asarray(acc), cfg)
    got = denoise.frame_count_denoising_gauss(t(img), t(acc), cfg, band_rows=16)
    assert max_abs(got, want) <= 1e-5
    # sigma 0 (accumulated robustness at the frame count): the pixel itself
    keep = n(denoise._acc_r_lookup(t(acc), img.shape[:2], scale)) >= 8
    np.testing.assert_array_equal(n(got)[keep], img[keep])


@pytest.fixture(scope="module")
def burst():
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=5, seed=6)
    return ref, comps


@pytest.mark.parametrize("which", ["median", "gauss"])
def test_process_arrays_denoiser(burst, which):
    """``process_arrays`` with the median or the Gauss denoiser (4 compared
    frames: every pixel's accumulated robustness is under the frame count
    8, so every pixel is smoothed), scan, the device finishing, against the
    JAX package with ``test_process_arrays_with_finishing``'s bounds; the
    accumulated robustness the denoiser read equal within the per-frame
    tolerance times the frame count."""
    ref, comps = burst
    jc, pc = jax_config(True), port_config(True)
    for c in (jc, pc):
        c.accumulated_robustness_denoiser[which].enabled = True
    img_j, dbg_j = j_process_arrays(ref, comps, jc, iso=100)
    img_t, dbg_t = P.process_arrays(ref, comps, pc, iso=100, device="cpu")
    assert tuple(img_t.shape) == (256, 256, 3)
    assert pc.accumulated_robustness_denoiser.enabled
    assert max_abs(dbg_t["accumulated_robustness"], dbg_j["accumulated_robustness"]) \
        < 1e-3 * len(comps)
    assert float(dbg_t["accumulated_robustness"].max()) < 8
    _check_finishing(img_t, img_j)
    assert kernel_counts() == (0,) * 8
