"""The port's noise model (``hmsr_tpu_torch.noise``) against the JAX
package's: the Monte-Carlo curves statistically (other random numbers, the
same estimator), the ISO-keyed curves and the affine fit exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import ALPHA, BETA  # noqa: E402

from hmsr_tpu.noise import fast_monte_carlo as j_mc  # noqa: E402
from hmsr_tpu_torch.noise import fast_monte_carlo as mc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


@pytest.fixture
def fresh_caches(monkeypatch, tmp_path):
    """Both packages compute anew and write their disk caches under
    ``tmp_path`` (the JAX package's default is /tmp/hmsr_noise_cache)."""
    monkeypatch.setattr(j_mc, "_CACHE", {})
    monkeypatch.setattr(j_mc, "_DISK_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(mc, "_CACHE", {})
    monkeypatch.setattr(mc, "DISK_CACHE_DIR", str(tmp_path / "port"))
    return tmp_path


def test_run_fast_mc_against_jax(fresh_caches):
    """The two packages' curves are independent estimates from 1e5 patches
    per level; the linearity bounds, which pick the MC levels, are equal.

    - std curve: every entry within 1e-2 relative (the sampling error of one
      estimate is ~6e-4 relative in the linear zone);
    - diff curve: |d| of a Gaussian d has a coefficient of variation of
      sqrt(pi/2 - 1) = 0.7555, so the difference of two estimates has a
      relative standard deviation of sqrt(2) * 0.7555 / sqrt(1e5) = 3.4e-3.
      A per-entry bound of 1e-2 is only 3 of those over ~60 MC levels (level
      15 differs by 1.06e-2 here); the test holds the mean over the entries
      to 1e-2 / 4 and every entry to 5 standard deviations (1.7e-2).
    The interpolated entries follow from their MC end points."""
    assert mc.N_PATCHES == j_mc.N_PATCHES
    assert mc.get_non_linearity_bound(ALPHA, BETA) == j_mc.get_non_linearity_bound(ALPHA, BETA)
    std, diff = mc.run_fast_MC(ALPHA, BETA, device="cpu")
    j_std, j_diff = j_mc.run_fast_MC(ALPHA, BETA)
    assert std.dtype == diff.dtype == np.float64 and std.shape == diff.shape == (1001,)
    np.testing.assert_allclose(std, j_std, rtol=1e-2)
    rel = np.abs(diff - j_diff) / j_diff
    sd = np.sqrt(2.0) * np.sqrt(np.pi / 2 - 1) / np.sqrt(mc.N_PATCHES)
    assert rel.mean() < 1e-2 / 4
    assert rel.max() < 5 * sd, (rel.max(), int(rel.argmax()))
    # the clipped ends: below the unclipped std there, as in the JAX tests
    assert std[0] < np.sqrt(BETA) and std[1000] < np.sqrt(ALPHA + BETA)


def test_run_fast_mc_cache(fresh_caches):
    """Cached in memory, and on disk in the port's own directory (never the
    JAX package's): a fresh process reads the same curves back."""
    a = mc.run_fast_MC(ALPHA, BETA, seed=1, device="cpu")
    assert mc.run_fast_MC(ALPHA, BETA, seed=1, device="cpu")[0] is a[0]
    files = os.listdir(fresh_caches / "port")
    assert len(files) == 1 and files[0].endswith("_cpu.npz")
    assert not (fresh_caches / "jax").exists()
    mc._CACHE.clear()
    b = mc.run_fast_MC(ALPHA, BETA, seed=1, device="cpu")
    assert b[0] is not a[0]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert mc.DISK_CACHE_DIR != j_mc._DISK_CACHE_DIR


def test_run_fast_mc_is_seeded(fresh_caches):
    levels = np.array([0.0, 0.01, 0.99, 1.0])
    s1, d1 = mc._regular_mc(levels, ALPHA, BETA, 5, torch.device("cpu"), n_patches=2000)
    s2, d2 = mc._regular_mc(levels, ALPHA, BETA, 5, torch.device("cpu"), n_patches=2000)
    s3, _ = mc._regular_mc(levels, ALPHA, BETA, 6, torch.device("cpu"), n_patches=2000)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(s1, s3)


@pytest.mark.parametrize("iso", [100, 141, 200, 800, 1600, 3200])
def test_iso_curves_and_fit_exact(iso):
    """``round_iso``, ``load_noise_curves`` and ``fit_alpha_beta`` give the
    JAX package's values exactly."""
    assert mc.round_iso(iso) == j_mc.round_iso(iso)
    std, diff = mc.load_noise_curves(iso, DATA)
    j_std, j_diff = j_mc.load_noise_curves(iso, DATA)
    np.testing.assert_array_equal(std, j_std)
    np.testing.assert_array_equal(diff, j_diff)
    assert mc.fit_alpha_beta(std) == j_mc.fit_alpha_beta(j_std)
    std32 = np.asarray(std, np.float32)          # as process_burst hands it over
    assert mc.fit_alpha_beta(std32) == j_mc.fit_alpha_beta(std32)


def test_missing_iso_curves_raise():
    with pytest.raises(OSError):
        mc.load_noise_curves(6400, DATA)
