"""The pipeline's switches besides the scale against the JAX package: the
decimating grey (``grey_method: decimating``, its flow moved to the raw
tile grid by ``flow_to_raw_grid``) and the bilinear and bicubic flow
upscaling (``ops/resize.py`` against ``jax.image.resize``); the chunked
pipeline's refusal of a fractional scale; ``tpu.merge_impl`` (``auto``,
``tiled``, ``gather``, ``pallas``) routed as the JAX package routes it, in
the scan, fused and chunked forms at x2 and x1.5 and in the sharded
pipeline on one rank.

E2E criteria (tools/verify_e2e_parity.py): flow max|d| < 1e-2, image
mean|d| < 1e-4 and max|d| < 1e-3 on the interior [8:-8, 8:-8].
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from torch_port_helpers import (WB, curves, default_config, kernel_counts, n,  # noqa: E402
                                small_config, t)

from hmsr_tpu.io.synthetic import (DEFAULT_CFA, make_occlusion_burst,  # noqa: E402
                                   make_synthetic_burst)
from hmsr_tpu.models import pipeline as j_pipeline  # noqa: E402
from hmsr_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from hmsr_tpu.parallel import make_sharded_pipeline as j_make_sharded  # noqa: E402
from hmsr_tpu.parallel import pad_frames as j_pad_frames  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.models import pipeline  # noqa: E402
from hmsr_tpu_torch.ops import resize  # noqa: E402
from hmsr_tpu_torch.parallel import (Mesh, make_sharded_pipeline, sharded,  # noqa: E402
                                     spawn_ranks)


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
    assert kernel_counts() == (0,) * 8


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
    assert kernel_counts() == (0,) * 8


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


# ---------------------------------------------------------------------------
# tpu.merge_impl, routed as the JAX package routes it
# ---------------------------------------------------------------------------

ROUTE_SIZE, ROUTE_FRAMES = 64, 3
MERGE_IMPLS = ("auto", "tiled", "gather", "pallas")
#: the JAX package's errors where it refuses a route: a tiled merge_impl at
#: a fractional scale (its _use_tiled), chunked without a tiled merge;
#: with ``pallas`` at x1.5 its scan form stops earlier, in merge_pallas's
#: assertion, where the port raises the tiled merge's ValueError
ROUTE_ERRORS = {(1.5, "tiled"): "tiled merge requires an integer scale",
                (1.5, "pallas"): "tiled merge requires an integer scale"}
CHUNKED_ERROR = "tpu.pipeline=chunked requires an integer scale"


def route_config(scale, impl, form):
    """The small two-level configuration at ``scale`` with ``tpu.merge_impl``
    ``impl`` and ``tpu.pipeline`` ``form``; the JAX side runs its Pallas
    merges in interpret mode (``pallas``, and the chunked form's burst
    merge whatever the impl)."""
    c = small_config(ROUTE_SIZE)
    c.scale = scale
    c.tpu.update(pipeline=form, merge_impl=impl, pallas_interpret=True)
    return c


def route_error(scale, impl, form):
    """The ValueError the route raises in the port, or None."""
    if (scale, impl) in ROUTE_ERRORS:
        return ROUTE_ERRORS[(scale, impl)]
    if form == "chunked" and (impl == "gather" or scale != int(scale)):
        return CHUNKED_ERROR
    return None


def jax_route_key(scale, impl, form):
    """The JAX program a route runs (routes with the same key run the same
    program): the fused form where the merge is tiled, the chunked form
    (K5''s twin whatever the impl), else the scan form with the per-frame
    merge its impl picks."""
    if scale != int(scale) or impl == "gather":
        return (scale, "scan", "gather")
    if form in ("fused", "chunked"):
        return (scale, form, "tiled")
    return (scale, "scan", "pallas" if impl == "pallas" else "tiled")


@pytest.fixture(scope="module")
def route_burst():
    ref, comps, _, _ = make_synthetic_burst(ROUTE_SIZE, ROUTE_SIZE,
                                            n_frames=ROUTE_FRAMES, seed=0)
    return ref, comps


@pytest.fixture(scope="module")
def jax_routes(route_burst):
    """The JAX image of each route key, computed once."""
    ref, comps = route_burst
    std, diff = curves()
    cache = {}

    def image(scale, impl, form):
        key = jax_route_key(scale, impl, form)
        if key not in cache:
            cache[key] = np.asarray(j_pipeline.make_pipeline(
                route_config(scale, impl, form), DEFAULT_CFA, WB)(
                jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std),
                jnp.asarray(diff))[0])
        return cache[key]
    return image


@pytest.mark.parametrize("form", ["scan", "fused", "chunked"])
@pytest.mark.parametrize("impl", MERGE_IMPLS)
@pytest.mark.parametrize("scale", [2, 1.5])
def test_merge_impl_route_against_jax(route_burst, jax_routes, scale, impl, form):
    """Each ``tpu.merge_impl`` in each form: where the JAX package refuses
    the route the port raises the same ``ValueError`` (JAX's scan form
    with ``pallas`` at x1.5 fails in an assertion first); elsewhere the
    image is within the e2e bounds of the JAX image of the same route, and
    ``fused`` where the merge is not tiled (``gather``, or ``auto`` at
    x1.5) is the scan form bit for bit."""
    ref, comps = route_burst
    std, diff = curves()
    config = route_config(scale, impl, form)
    err = route_error(scale, impl, form)
    if err is not None:
        with pytest.raises(ValueError, match=err):
            pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")
        with pytest.raises((ValueError, AssertionError)):
            j_pipeline.make_pipeline(config, DEFAULT_CFA, WB)(
                jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std),
                jnp.asarray(diff))
        return
    img_t, _ = pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std,
                                                                      diff)
    out = round(scale * ROUTE_SIZE)
    assert tuple(img_t.shape) == (out, out, 3)
    d = np.abs(n(img_t) - jax_routes(scale, impl, form))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3, (d.mean(), d.max())
    if form == "fused" and pipeline.pipeline_form(config) == "scan":
        config.tpu.pipeline = "scan"
        img_s, _ = pipeline.make_pipeline(config, DEFAULT_CFA, WB, "cpu")(
            ref, comps, std, diff)
        assert torch.equal(img_t, img_s)
    assert kernel_counts() == (0,) * 8


#: (scale, merge_impl) of the sharded routes: K5's banded branch at x2
#: unless gather, the gather merge at x1.5 whatever the impl (the JAX
#: package's sharded pipeline refuses no impl there)
SHARDED_ROUTES = [(2, "auto"), (2, "tiled"), (2, "gather"), (2, "pallas"),
                  (1.5, "auto"), (1.5, "tiled")]


@pytest.fixture(scope="module")
def sharded_routes(route_burst, tmp_path_factory):
    """The port's sharded pipeline on a (1, 1) mesh in one gloo rank, once
    per route of :data:`SHARDED_ROUTES`: ``{route: image}``."""
    ref, comps = route_burst
    cfgs = [configs.merge({}, route_config(scale, impl, "scan"))
            for scale, impl in SHARDED_ROUTES]
    images = spawn_ranks(ranks.sharded_images, 1, args=(t(ref), t(comps), cfgs),
                         tmp_dir=str(tmp_path_factory.mktemp("routes")), threads=1)[0]
    return dict(zip(SHARDED_ROUTES, images))


@pytest.mark.parametrize("route", SHARDED_ROUTES)
def test_sharded_merge_impl_route_against_jax(route_burst, sharded_routes, route):
    """The sharded pipeline routes ``tpu.merge_impl`` as the JAX package's
    does (``hmsr_tpu/parallel/sharded.py:82-88``): the image of a one-rank
    mesh within the e2e bounds of the JAX sharded pipeline on a (1, 1)
    mesh."""
    ref, comps = route_burst
    scale, impl = route
    std, diff = curves()
    frames, weights = j_pad_frames(comps, 1)
    pipe = j_make_sharded(route_config(scale, impl, "scan"), DEFAULT_CFA, WB,
                          j_make_mesh(1, 1))
    want = pipe(jnp.asarray(ref), jnp.asarray(frames), jnp.asarray(weights),
                jnp.asarray(std), jnp.asarray(diff))[0]
    got = sharded_routes[route]
    out = round(scale * ROUTE_SIZE)
    assert tuple(got.shape) == (out, out, 3)
    d = np.abs(n(got) - np.asarray(want))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3, (d.mean(), d.max())


@pytest.mark.parametrize("impl", MERGE_IMPLS)
@pytest.mark.parametrize("scale", [2, 1.5])
def test_sharded_pipeline_takes_the_route(monkeypatch, scale, impl):
    """The sharded pipeline's merge and band geometry are the route's
    (``pipeline.route_of``), with no rule of its own: K5 into whole tile
    rows where the merge is tiled (x2 unless ``gather``), the gather merge
    into ``out_h / n_space`` rows otherwise. At x1.5 the route refuses a
    tiled impl to the single-device pipeline, and the sharded pipeline
    takes the gather merge there, as the JAX package's does. No burst
    runs: the merge is the one the pipeline closes over."""
    config = route_config(scale, impl, "scan")
    route = pipeline.route_of(config)
    tiled = scale == 2 and impl != "gather"
    assert route.tiled == tiled
    assert (route.refusal is not None) == (scale == 1.5 and impl in ("tiled", "pallas"))
    picks = {"merge_tiled": object(), "merge": object()}
    for name, fn in picks.items():
        monkeypatch.setattr(pipeline, name, fn)
    mesh = Mesh(1, 2, 0, 0, None, None, (0,), (0, 1), None)
    fn = make_sharded_pipeline(config, DEFAULT_CFA, WB, mesh, "cpu")
    assert inspect.getclosurevars(fn).nonlocals["merge_frame"] is \
        picks["merge_tiled" if tiled else "merge"]
    # 80 raw rows: 160 HR rows at x2 are 5 tile rows of B = 32, 3 a band
    B = int(config.block_matching.tuning.tile_size) * 2
    assert sharded.band_geometry(config, (80, 64), 2) == \
        (3 * B if tiled else round(scale * 80) // 2)
