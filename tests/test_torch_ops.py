"""The port's ops leaves against the JAX package's (max|d| <= 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import max_abs, n, t  # noqa: E402

from hmsr_tpu.ops.gat import gat as j_gat  # noqa: E402
from hmsr_tpu.ops import (accumfix as j_accumfix, dogson as j_dogson,  # noqa: E402
                          gradients as j_grad, grey as j_grey,
                          linalg2x2 as j_linalg, lut as j_lut, pyramid as j_pyr,
                          stencils as j_sten)
from hmsr_tpu_torch import convert  # noqa: E402
from hmsr_tpu_torch.ops import (accumfix, dogson, gat, gradients, grey,  # noqa: E402
                                linalg2x2, lut, pyramid, stencils)

TOL = 1e-5


def _img(seed, shape, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def test_gat():
    """Relative: VST values are O(2/alpha) ~ 1e4."""
    x = _img(0, (33, 47))
    got = n(gat.gat(t(x), 1.8e-4, 3e-6))
    want = np.asarray(j_gat(jnp.asarray(x), 1.8e-4, 3e-6))
    assert np.max(np.abs(got - want) / np.abs(want)) <= TOL


def test_gat_rejects_nonpositive_alpha():
    with pytest.raises(ValueError):
        gat.gat(t(_img(0, (4, 4))), 0.0, 1e-6)


@pytest.mark.parametrize("shape", [(3, 20, 28), (17, 9)])
def test_local_stats_3x3(shape):
    x = _img(1, shape)
    m_t, v_t = stencils.local_stats_3x3(t(x))
    m_j, v_j = j_sten.local_stats_3x3(jnp.asarray(x))
    assert max_abs(m_t, m_j) <= TOL and max_abs(v_t, v_j) <= TOL


def test_local_min_5x5():
    x = _img(2, (2, 23, 31))
    assert max_abs(stencils.local_min_5x5(t(x)), j_sten.local_min_5x5(jnp.asarray(x))) == 0.0


def test_box_sum_valid():
    """Relative to the largest sum: both sides difference integral images,
    whose cumulative sums round in their own order."""
    x = _img(3, (4, 5, 26, 26))
    want = j_sten.box_sum_valid(jnp.asarray(x), 16)
    assert max_abs(stencils.box_sum_valid(t(x), 16), want) <= TOL * float(jnp.max(want))


def test_gradients():
    x = _img(4, (21, 30))
    gx_t, gy_t = gradients.sobel_gradients(t(x))
    gx_j, gy_j = j_grad.sobel_gradients(jnp.asarray(x))
    assert max_abs(gx_t, gx_j) <= TOL and max_abs(gy_t, gy_j) <= TOL
    assert max_abs(gradients.halfpixel_gradients(t(x)),
                   j_grad.halfpixel_gradients(jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_downsample(factor):
    x = _img(5, (75, 90))
    np.testing.assert_array_equal(pyramid.gaussian_kernel1d(factor * 0.5, 2 * factor),
                                  j_pyr.gaussian_kernel1d(factor * 0.5, 2 * factor))
    assert max_abs(pyramid.downsample(t(x), factor),
                   j_pyr.downsample(jnp.asarray(x), factor, impl="slices")) <= TOL


def test_build_gaussian_pyramid():
    x = _img(6, (160, 192))
    got = pyramid.build_gaussian_pyramid(t(x), [1, 2, 4, 4])
    want = j_pyr.build_gaussian_pyramid(jnp.asarray(x), [1, 2, 4, 4])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert max_abs(g, w) <= TOL


def test_linalg2x2():
    rng = np.random.RandomState(7)
    a, b, d = (rng.uniform(0, 2, (50,)).astype(np.float32) for _ in range(3))
    b[:5] = 0.0
    d[:5] = a[:5]                   # identity multiples
    a[5:10] = b[5:10]               # v0 == 0 cases after the eigen shift
    m = [a, b, b, d]
    got = linalg2x2.eigen_2x2(*map(t, m))
    want = j_linalg.eigen_2x2(*map(jnp.asarray, m))
    for g, w in zip(got, want):
        for gg, ww in zip(g, w):
            assert max_abs(gg, ww) <= TOL
    sing = [np.array([1.0, 2.0, 1e-6], np.float32), np.array([0.5, 1.0, 0.0], np.float32),
            np.array([0.5, 1.0, 0.0], np.float32), np.array([3.0, 0.5, 1e-6], np.float32)]
    for g, w in zip(linalg2x2.invert_2x2(*map(t, sing)),
                    j_linalg.invert_2x2(*map(jnp.asarray, sing))):
        assert max_abs(g, w) <= TOL


def test_dogson():
    x = np.linspace(-2, 2, 401).astype(np.float32)
    assert max_abs(dogson.dogson_quadratic_kernel(t(x)),
                   j_dogson.dogson_quadratic_kernel(jnp.asarray(x))) <= TOL


def test_lut_lookup():
    rng = np.random.RandomState(8)
    tabs = [rng.rand(1001).astype(np.float32) for _ in range(2)]
    x = rng.uniform(-0.1, 1.1, (3, 17, 13)).astype(np.float32)
    x[0, 0, :4] = [0.0005, 0.0015, 0.0025, 1.0]      # half-to-even ties
    got = lut.lut_lookup([t(a) for a in tabs], t(x))
    want = j_lut.lut_lookup([jnp.asarray(a) for a in tabs], jnp.asarray(x))
    for g, w in zip(got, want):
        assert max_abs(g, w) == 0.0


@pytest.mark.parametrize("shape", [(64, 80), (130, 126), (66, 74)])
def test_fft_lowpass_grey(shape):
    """Includes sizes that are not multiples of 4 (asymmetric band)."""
    x = _img(9, shape)
    assert max_abs(grey.fft_lowpass_grey(t(x)), j_grey.fft_lowpass_grey(jnp.asarray(x))) <= TOL


def test_decimate_and_dispatch():
    x = _img(10, (40, 54))
    assert max_abs(grey.decimate_to_grey(t(x)),
                   j_grey.decimate_to_grey(jnp.asarray(x), impl="reshape")) <= TOL
    assert max_abs(grey.compute_grey_image(t(x), "FFT"),
                   j_grey.compute_grey_image(jnp.asarray(x), "FFT", impl="fft")) <= TOL
    with pytest.raises(NotImplementedError):
        grey.compute_grey_image(t(x), "median")


@pytest.mark.parametrize("border", [None, 32])
def test_normalize_accum(border):
    """Starved pixels (den < 1e-4) near the border are refilled; with
    ``refill_border=32`` only the border strips run the refill."""
    rng = np.random.RandomState(11)
    num = rng.rand(3, 96, 112).astype(np.float32)
    den = rng.uniform(0.5, 1.5, (3, 96, 112)).astype(np.float32)
    den[:, :3, 10:14] = 1e-7
    den[1, -2:, -5:] = 0.0
    den[2, 40:42, :2] = 1e-9
    got = accumfix.normalize_accum(t(num), t(den), refill_border=border)
    want = j_accumfix.normalize_accum(jnp.asarray(num), jnp.asarray(den),
                                      refill_border=border)
    assert max_abs(got, want) <= TOL


def test_normalize_accum_deep_starved():
    """Starved pixels at depths 28-44 from every edge: on both sides of the
    32-px strips' edge and of their 8-px margin. The port's border refill
    (``normalize_accum`` and K7's wrapper, which takes it on the CPU)
    against the JAX package's."""
    from hmsr_tpu_torch.ops import cuda_merge
    rng = np.random.RandomState(12)
    num = rng.rand(3, 128, 144).astype(np.float32)
    den = rng.uniform(0.5, 1.5, (3, 128, 144)).astype(np.float32)
    for d in range(28, 45, 3):
        den[:, d:d + 2, 50:53] = 1e-7
        den[0, -1 - d, 90:92] = 0.0
        den[1, 60:63, d:d + 2] = 1e-9
        den[2, 70:72, -1 - d] = 0.0
        den[:, d, d] = 0.0
    want = j_accumfix.normalize_accum(jnp.asarray(num), jnp.asarray(den),
                                      refill_border=32)
    for got in (accumfix.normalize_accum(t(num), t(den), refill_border=32),
                cuda_merge.refill_image(t(num), t(den), 32)):
        assert max_abs(got, want) <= TOL


def test_from_numpy_converts_state():
    """JAX per-burst state, turned into numpy, becomes the port's types."""
    import jax
    from hmsr_tpu.models.ica import init_ica as j_init_ica
    from hmsr_tpu_torch.models.ica import IcaRefState
    state = jax.tree_util.tree_map(np.asarray, j_init_ica(jnp.asarray(_img(12, (32, 48))), 16))
    got = convert.from_numpy({"ica": [state], "curve": np.zeros(3, np.float32)}, "cpu")
    assert isinstance(got["ica"][0], IcaRefState)
    assert tuple(got["ica"][0].hessian.shape) == (2, 3, 2, 2)
    assert got["curve"].dtype == torch.float32
    with pytest.raises(TypeError):
        convert.from_numpy(object(), "cpu")
