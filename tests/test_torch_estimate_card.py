"""K12 (``csrc/estimate.cu``, the merge kernels' covariances of one frame) on
the card against its plain version
:func:`hmsr_tpu_torch.ops.cuda_estimate.estimate_kernels_plain` on the card,
bit for bit: Bayer and grey mode under both selection laws at 3000x4000 (the
cells' frames), odd sizes and sizes that are no multiple of the block's
32x64 grey tile, a ``D_tr`` whose float32 reciprocal is inexact, a flat frame
(tr = 0 and the identity case), axis-aligned step edges (``v0 == 0`` and
``v1 == 0``), values that drive the VST below zero (its clamp), and one
launch a call through ``estimate_kernels``.

Marked ``card``: they skip without a CUDA card. On a host with one::

    python -m pytest --noconftest tests/test_torch_estimate_card.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX, which the card's
host need not have; this file imports neither JAX nor the JAX package.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hmsr_tpu_torch.models.kernels import estimate_kernels  # noqa: E402
from hmsr_tpu_torch.ops import cuda_estimate  # noqa: E402
from hmsr_tpu_torch.synthetic import burst_config  # noqa: E402

MODES = ("bayer", "grey")
LAWS = ("hard_threshold", "linear")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.device("cuda")


def _config(mode, law, snr=40):
    """The main path's tuning at ``snr`` (40: D_tr = 1; 18: D_tr = 1.12,
    whose float32 reciprocal is inexact)."""
    config = burst_config((3000, 4000), snr)
    config.mode = mode
    config.merging.selection_law = law
    return config


def _noisy(shape, seed, block=4):
    """A blocky scene with 2 % noise, and near its top-left corner a flat
    patch, vertical and horizontal step edges and values below the VST's
    zero."""
    rng = np.random.RandomState(seed)
    h, w = shape
    base = rng.rand(h // block + 1, w // block + 1).astype(np.float32)
    img = np.kron(base, np.ones((block, block), np.float32))[:h, :w]
    img = img + 0.02 * rng.randn(h, w).astype(np.float32)
    ph, pw = h // 8, w // 4
    img[:ph, :pw] = 0.4
    img[ph:2 * ph, :pw] = np.kron(rng.rand(1, pw) > 0.5, np.ones((ph, 1)))[:, :pw]
    img[2 * ph:3 * ph, :pw] = np.kron(rng.rand(ph, 1) > 0.5, np.ones((1, pw)))
    img[3 * ph:4 * ph, :pw] = -0.5 * rng.rand(ph, pw)
    return np.ascontiguousarray(img, np.float32)


def _check(img, config, device):
    """K12 on ``img`` equal to the plain version on the card, bit for bit
    (the same NaN set), one launch; returns the covariances."""
    x = torch.as_tensor(img, device=device)
    want = cuda_estimate.estimate_kernels_plain(x, config)
    before = cuda_estimate.estimate_kernels_fused.launches
    got = estimate_kernels(x, config)
    torch.cuda.synchronize()
    assert cuda_estimate.estimate_kernels_fused.launches == before + 1
    assert got.is_contiguous() and got.shape == want.shape
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    d = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    assert torch.equal(got[fin], want[fin]), f"max|d| {d:.3e}"
    return want


@pytest.mark.card
@pytest.mark.parametrize("snr", [40, 18])
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("mode", MODES)
def test_k12_equals_plain_at_cell_size(cuda, mode, law, snr):
    """3000 x 4000, the cells' frames."""
    _check(_noisy((3000, 4000), 1, block=8), _config(mode, law, snr), cuda)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 2), (3, 5), (301, 405), (65, 129), (64, 128),
                                   (66, 130), (1001, 1503)])
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("mode", MODES)
def test_k12_odd_sizes(cuda, mode, law, shape):
    """One grey pixel up to several tiles, odd sizes (Bayer mode crops the
    last row and column) and one row or column past a tile."""
    _check(_noisy(shape, 2, block=2), _config(mode, law, 18), cuda)


@pytest.mark.card
@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("mode", MODES)
def test_k12_flat_frame(cuda, mode, law):
    """No gradient: tr = 0 (A = 1) and m01 == 0 & m00 == m11 (the identity
    eigenvectors) at every pixel, so every covariance is the same."""
    want = _check(np.full((70, 98), 0.4, np.float32), _config(mode, law), cuda)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(want, want[:, :1, :1].expand_as(want))


@pytest.mark.card
def test_k12_strided_frame(cuda):
    """A frame that is a view (a stack's slice and a crop) is read as the
    plain version reads it."""
    stack = torch.as_tensor(np.stack([_noisy((130, 258), s) for s in (5, 6)]),
                            device=cuda)
    for img in (stack[1], stack[0, 1:, 3:]):
        _check(img, _config("bayer", "hard_threshold"), cuda)
