"""The pipeline's switches besides the scale against the JAX package: the
decimating grey (``grey_method: decimating``, its flow moved to the raw
tile grid by ``flow_to_raw_grid``) and the bilinear and bicubic flow
upscaling (``ops/resize.py`` against ``jax.image.resize``); the chunked
pipeline's refusal of a fractional scale.

E2E criteria (tools/verify_e2e_parity.py): flow max|d| < 1e-2, image
mean|d| < 1e-4 and max|d| < 1e-3 on the interior [8:-8, 8:-8].
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import (WB, curves, default_config, kernel_counts, n,  # noqa: E402
                                small_config, t)

from hmsr_tpu.io.synthetic import (DEFAULT_CFA, make_occlusion_burst,  # noqa: E402
                                   make_synthetic_burst)
from hmsr_tpu.models import pipeline as j_pipeline  # noqa: E402
from hmsr_tpu_torch.models import pipeline  # noqa: E402
from hmsr_tpu_torch.ops import resize  # noqa: E402


def _config(cfg):
    """``(size, config, burst maker)``: the decimating grey on the 2-level
    small configuration at 128^2; the flow modes on the ``bench.py``
    configuration (4 levels, upscales by 2 and 4) at 256^2 on a burst with
    a moving disc, whose flow varies from tile to tile (on a global shift
    the upscaled flows are flat and every mode gives the nearest one)."""
    if cfg == "decimating":
        config = small_config(128)
        config.grey_method = "decimating"
        return 128, config, make_synthetic_burst
    config = default_config(256)
    config.block_matching.tuning.flow_upscale_mode = cfg
    return 256, config, make_occlusion_burst


@pytest.mark.parametrize("cfg", ["decimating", "bilinear", "bicubic"])
def test_e2e_switch_against_jax_scan(cfg):
    size, config, make = _config(cfg)
    config.debug = True
    ref, comps = make(size, size, n_frames=4, seed=0)[:2]
    std, diff = curves()
    img_j, dbg_j = j_pipeline.make_pipeline(config, DEFAULT_CFA, WB)(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))
    img_t, dbg_t = pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")(
        ref, comps, std, diff)
    assert tuple(img_t.shape) == (2 * size, 2 * size, 3)
    # the flows on the raw tile grid (decimating: converted from the grey one)
    assert tuple(dbg_t["flow"].shape) == (3, size // 16, size // 16, 2)
    d_img = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert np.abs(n(dbg_t["flow"]) - np.asarray(dbg_j["flow"])).max() < 1e-2
    assert d_img.mean() < 1e-4
    assert d_img.max() < 1e-3
    assert np.abs(n(dbg_t["robustness"]) - np.asarray(dbg_j["robustness"])).max() < 1e-3
    assert kernel_counts() == (0,) * 7


def test_chunked_equals_scan_decimating():
    """With the decimating grey the chunked pipeline (chunks of 2) equals
    the scan pipeline exactly: its analysis converts the flows the same
    way."""
    config = small_config(128)
    config.grey_method = "decimating"
    config.debug = True
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4, seed=5)
    std, diff = curves()
    img_s, dbg_s = pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")(
        ref, comps, std, diff)
    config.tpu.pipeline = "chunked"
    config.tpu.merge_chunk = 2
    img_c, dbg_c = pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")(
        ref, comps, std, diff)
    assert torch.equal(img_c, img_s)
    assert all(torch.equal(dbg_c[k], dbg_s[k]) for k in dbg_s)
    assert kernel_counts() == (0,) * 7


def test_chunked_fractional_scale_raises():
    """``tpu.pipeline=chunked`` at a fractional scale raises the JAX
    package's ``ValueError`` in both packages (K5' needs an integer scale)."""
    config = small_config(128)
    config.scale = 1.5
    config.tpu.pipeline = "chunked"
    frames = np.zeros((3, 128, 128), np.float32)
    std, diff = curves()
    with pytest.raises(ValueError, match="integer scale"):
        pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")
    with pytest.raises(ValueError, match="integer scale"):
        j_pipeline.make_pipeline(config, DEFAULT_CFA, WB)(
            jnp.asarray(frames[0]), jnp.asarray(frames[1:]), jnp.asarray(std),
            jnp.asarray(diff))


@pytest.mark.parametrize("grey_tiles,raw_shape,ts", [
    ((4, 6), (128, 192), 16),       # 2x2 repeats cover the raw grid exactly
    ((3, 5), (100, 150), 16),       # odd raw tile counts: cropped
    ((2, 3), (200, 260), 32),       # more raw tiles than repeats: edge-padded
])
def test_flow_to_raw_grid(grey_tiles, raw_shape, ts):
    flow = np.random.RandomState(3).uniform(-5, 5, grey_tiles + (2,)).astype(np.float32)
    got = pipeline.flow_to_raw_grid(t(flow), raw_shape, ts)
    want = j_pipeline.flow_to_raw_grid(jnp.asarray(flow), raw_shape, ts)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("factor", [2, 4])
def test_resize_against_jax(method, factor):
    """``ops.resize.resize`` against ``jax.image.resize`` within 1e-6 on flow
    grids, grids one tile wide and one tile high included (there the
    renormalised edge weights make each output a copy of its one input)."""
    rng = np.random.RandomState(factor)
    for shape in ((1, 1), (1, 7), (6, 1), (2, 3), (12, 17), (47, 63)):
        x = rng.uniform(-3, 3, shape + (2,)).astype(np.float32)
        out = (shape[0] * factor, shape[1] * factor)
        got = resize.resize(t(x), out, method)
        want = jax.image.resize(jnp.asarray(x), out + (2,), method=method)
        assert float(np.abs(n(got) - np.asarray(want)).max()) <= 1e-6, shape


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("n_in,n_out", [(5, 10), (6, 24), (1, 4), (8, 8), (8, 4)])
def test_resize_weights_follow_jax_rule(method, n_in, n_out):
    """Each axis' weight matrix equals JAX's (read off ``jax.image.resize``
    of an identity, whose contraction with a one-hot column is exact):
    edges renormalised, no taps outside the input, the identity at equal
    sizes, and a downsampling by 2 widening the kernel (antialiased). Keys'
    cubic has a = -0.5: a sample at 2.25 (x2) weighs inputs 1..4 -0.0703125,
    0.8671875, 0.2265625 and -0.0234375."""
    w = resize.weight_matrix_np(n_in, n_out, method)
    want = jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in), method=method)
    np.testing.assert_array_equal(w, np.asarray(want).T)
    if n_in == n_out:
        np.testing.assert_array_equal(w, np.eye(n_in, dtype=np.float32))
    if method == "cubic" and (n_in, n_out) == (6, 24):
        np.testing.assert_array_equal(resize.weight_matrix_np(6, 12, "cubic")[1:5, 5],
                                      [-0.0703125, 0.8671875, 0.2265625, -0.0234375])
