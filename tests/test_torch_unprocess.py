"""The port's inverse ISP (``finishing/unprocess.py``) against the JAX
package's numpy module, on the CPU.

The JAX module draws from the global ``random`` and ``np.random``; the port
takes a ``random.Random`` and a ``np.random.RandomState``. Seeded alike they
draw the same numbers, so the metadata agrees exactly and the image within
1e-12 in float64 and 1e-6 in float32 (the numpy module computes in float64
from the CCM on).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hmsr_tpu.finishing import unprocess as j_unprocess  # noqa: E402
from hmsr_tpu_torch.finishing import unprocess  # noqa: E402

TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _jpg(seed, h=37, w=53):
    """An sRGB-like image in [0, 1] with saturated and near-white pixels."""
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3)
    img[:4] = 1.0
    img[4:8, :, 0] = 0.0
    img[8:12] = 0.93 + 0.07 * rng.rand(4, w, 3)
    return img


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [0, 5])
def test_unprocess_isp_against_jax(dtype, seed):
    jpg = _jpg(seed)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    random.seed(seed)
    np.random.seed(seed)
    want, want_meta = j_unprocess.unprocess_isp(jpg.astype(np_dtype))
    got, meta = unprocess.unprocess_isp(torch.as_tensor(jpg, dtype=dtype),
                                        random.Random(seed), np.random.RandomState(seed))
    assert got.dtype == dtype and tuple(got.shape) == jpg.shape
    assert meta.keys() == want_meta.keys()
    for k, v in want_meta.items():
        np.testing.assert_array_equal(meta[k], v)
    assert np.abs(got.numpy() - want).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pixel_steps_against_jax(dtype):
    """Each per-pixel step alone: the inverse smoothstep, the gamma
    expansion, the safe inversion of the gains and the forward gains (RGB and
    RGGB)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    jpg = _jpg(3).astype(np_dtype)
    x = torch.as_tensor(jpg)
    gains = (1.3, 2.1, 1.7)        # rgb, red, blue
    pairs = [
        (unprocess.invert_smoothstep(x), j_unprocess.invert_smoothstep(jpg)),
        (unprocess.gamma_expansion(x), j_unprocess.gamma_expansion(jpg)),
        (unprocess.safe_invert_gains(x, gains[1], gains[2], gains[0]),
         j_unprocess.safe_invert_gains(jpg, gains[1], gains[2], gains[0])),
        (unprocess.apply_gains(x, gains[1], gains[2], gains[0]),
         j_unprocess.apply_gains(jpg, gains[1], gains[2], gains[0])),
    ]
    rggb = np.concatenate([jpg, jpg[..., 1:2]], -1)
    pairs.append((unprocess.apply_gains(torch.as_tensor(rggb), gains[1], gains[2],
                                        gains[0]),
                  j_unprocess.apply_gains(rggb, gains[1], gains[2], gains[0])))
    for got, want in pairs:
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - want).max() <= TOL[dtype]


def test_draws_against_jax():
    """The CCM, gains and noise levels, drawn from explicit generators, are
    the JAX module's draws from its seeded globals."""
    random.seed(11)
    np.random.seed(11)
    want = (j_unprocess.get_random_ccm(), j_unprocess.get_random_gains(),
            j_unprocess.get_random_noise_parameters(log_max_shot=0.02))
    rng, np_rng = random.Random(11), np.random.RandomState(11)
    got = (unprocess.get_random_ccm(np_rng), unprocess.get_random_gains(rng),
           unprocess.get_random_noise_parameters(rng, log_max_shot=0.02))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[0].sum(-1), 1.0, rtol=1e-12)
    assert got[1:] == want[1:]


def test_shapes_refused():
    x = torch.zeros(4, 4, 2)
    with pytest.raises(ValueError):
        unprocess.safe_invert_gains(x, 2.0, 1.5, 1.2)
    with pytest.raises(ValueError):
        unprocess.apply_gains(x, 2.0, 1.5, 1.2)
