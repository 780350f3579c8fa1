"""The port's merges at a fractional scale against the JAX package: the
gather merge of a compared frame (``hmsr_tpu_torch.models.merge.merge``
against ``hmsr_tpu.models.merge.merge``) and the banded reference merge
(``merge_ref_tiled`` against ``merge_ref``), every variant, num/den within
1e-5 relative; the LR tile and robustness picks exactly; and the scan
pipeline at x1.5 and x2.5 end to end against the JAX scan pipeline.

The merges hold against JAX evaluated op by op (``jax.disable_jit``):
compiled, XLA divides by a constant through its rounded reciprocal, which
the port does not do (it divides by a device tensor, on the card as on the
CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import (WB, curves, kernel_counts, n, rel_err, small_config,  # noqa: E402,E501
                                t)

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models import kernels as j_kernels  # noqa: E402
from hmsr_tpu.models import merge as j_merge  # noqa: E402
from hmsr_tpu.models.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from hmsr_tpu_torch.models import merge, merge_tiled  # noqa: E402
from hmsr_tpu_torch.models.pipeline import make_pipeline  # noqa: E402

H, W, TS = 40, 56, 16
VARIANTS = {"bayer": ("bayer", "steerable"), "grey": ("grey", "steerable"),
            "iso": ("bayer", "iso"), "grey-iso": ("grey", "iso")}
CASES = [pytest.param(v, s, id=f"{v}-x{s}") for v in VARIANTS for s in (1.5, 2.5)]


@pytest.fixture(scope="module")
def frames():
    ref, comps, _, _ = make_synthetic_burst(H, W, n_frames=2, seed=11)
    return ref, comps[0]


def _setup(variant, scale, seed):
    """Configuration, accumulators (random, so that the in-place update is
    held too) and covariances of the variant at ``scale``."""
    config = small_config(128, TS)
    config.scale = scale
    config.mode, config.merging.kernel = VARIANTS[variant]
    rng = np.random.RandomState(seed)
    shape = (3 if config.mode == "bayer" else 1, round(scale * H), round(scale * W))
    num = rng.rand(*shape).astype(np.float32)
    den = rng.rand(*shape).astype(np.float32)
    return config, rng, num, den


@pytest.mark.parametrize("variant,scale", CASES)
def test_merge_gather(frames, variant, scale):
    """One compared frame: flows with negative and half-integer values, and
    tiles pushed out of the frame (their weight is zero); grey mode's
    covariances on the raw grid. Evaluated in bands of 24 HR rows."""
    _, comp = frames
    config, rng, num, den = _setup(variant, scale, 1)
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(comp), config))
    flow = rng.uniform(-3, 3, (-(-H // TS), -(-W // TS), 2)).astype(np.float32)
    flow[0, 0] = (-40.0, 7.5)
    flow[-1, -1] = (0.5, -1.5)
    r = rng.rand(H, W).astype(np.float32)
    with jax.disable_jit():
        want = j_merge.merge(jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(covs),
                             jnp.asarray(r), jnp.asarray(num), jnp.asarray(den),
                             DEFAULT_CFA, config)
    got_n, got_d = t(num), t(den)
    out = merge.merge(t(comp), t(flow), t(covs), t(r), got_n, got_d, DEFAULT_CFA, config,
                      band_rows=24)
    assert out[0] is got_n and out[1] is got_d          # in place
    assert rel_err(got_n, want[0]) <= 1e-5
    assert rel_err(got_d, want[1]) <= 1e-5
    assert kernel_counts() == (0,) * 7


@pytest.mark.parametrize("variant,scale", CASES + [
    pytest.param("bayer", 1.5, id="bayer-x1.5-denoiser"),
    pytest.param("grey", 1.5, id="grey-x1.5-denoiser")])
def test_merge_ref_fractional(frames, variant, scale, request):
    """The reference merge at a fractional scale (guarded inverse, taps
    centred on ``round(R/s)``), and with the accumulated-robustness
    denoiser: an accumulated robustness spread over [0, 4] so that pixels
    take the 5x5 taps, the 3x3 ones, and are overwritten or added to."""
    ref, _ = frames
    config, rng, num, den = _setup(variant, scale, 2)
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(ref), config))
    acc = None
    if request.node.callspec.id.endswith("denoiser"):
        config.accumulated_robustness_denoiser.enabled = True
        acc = rng.uniform(0, 4, (H, W)).astype(np.float32)
    with jax.disable_jit():
        want = j_merge.merge_ref(jnp.asarray(ref), jnp.asarray(covs), jnp.asarray(num),
                                 jnp.asarray(den), DEFAULT_CFA, config,
                                 acc_rob=None if acc is None else jnp.asarray(acc))
    got_n, got_d = t(num), t(den)
    merge_tiled.merge_ref_tiled(t(ref), t(covs), got_n, got_d, DEFAULT_CFA, config,
                                acc_rob=None if acc is None else t(acc), band_rows=24)
    assert rel_err(got_n, want[0]) <= 1e-5
    assert rel_err(got_d, want[1]) <= 1e-5


@pytest.mark.parametrize("scale", [1.5, 2.5, 3, 1.25])
@pytest.mark.parametrize("ts", [16, 64])
def test_lr_positions_exact(scale, ts):
    """The gather merge's integer picks over a 48 MP-wide HR row (9000 at
    x1.5): the flow tile ``lr // ts`` and the robustness index ``int(lr)``
    equal JAX's op-by-op ones exactly, and the floor division equals JAX's
    float ``//`` on values at, just under and just over every tile
    boundary (LR positions are positive: the boundary at 0 is approached
    from above only; JAX flushes the denormal below it to 0)."""
    hr = np.arange(int(6000 * scale), dtype=np.float32)
    lr, tile, idx = merge.lr_positions(torch.as_tensor(hr).to(torch.int64), scale, ts)
    with jax.disable_jit():
        j_lr = (jnp.asarray(hr) + 0.5) / scale
        j_tile = (j_lr // ts).astype(jnp.int32)
        j_idx = j_lr.astype(jnp.int32)
    np.testing.assert_array_equal(n(lr), np.asarray(j_lr))
    np.testing.assert_array_equal(n(tile), np.asarray(j_tile))
    np.testing.assert_array_equal(n(idx), np.asarray(j_idx))
    edges = np.arange(0, 9000, ts, dtype=np.float32)
    x = np.concatenate([edges, np.nextafter(edges[1:], -np.inf),
                        np.nextafter(edges, np.inf)])
    got = torch.div(torch.as_tensor(x), torch.full((), float(ts)), rounding_mode="floor")
    np.testing.assert_array_equal(n(got), np.asarray(jnp.asarray(x) // ts))


@pytest.mark.parametrize("cfg", ["x1.5", "x2.5", "x1.5-grey", "x1.5-denoiser"])
def test_e2e_fractional_against_jax_scan(cfg):
    """The port's scan pipeline at a fractional scale (the gather merge and
    the banded reference merge) against the JAX scan pipeline with the e2e
    criteria (flow max|d| < 1e-2, image mean|d| < 1e-4 and max|d| < 1e-3
    on the interior), 128^2, 4 frames. The denoiser case lowers
    ``merge.max_frame_count`` to 3 so that its wide taps and its overwrite
    reach most pixels of a 4-frame burst. Grey mode holds against the JAX
    pipeline without its outer ``jit``, as ``test_e2e_against_jax_scan``'s
    grey case does (compiled, XLA moves grey mode's near-isotropic
    covariances)."""
    config = small_config(128)
    config.scale = 2.5 if "x2.5" in cfg else 1.5
    config.debug = True
    if "grey" in cfg:
        config.mode = "grey"
    if "denoiser" in cfg:
        config.accumulated_robustness_denoiser.enabled = True
        config.accumulated_robustness_denoiser.merge.max_frame_count = 3
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4, seed=0)
    std, diff = curves()
    img_j, dbg_j = j_make_pipeline(config, DEFAULT_CFA, WB, jit="grey" not in cfg)(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))
    img_t, dbg_t = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    side = round(config.scale * 128)
    assert tuple(img_t.shape) == (side, side, 3 if config.mode == "bayer" else 1)
    d_img = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert np.abs(n(dbg_t["flow"]) - np.asarray(dbg_j["flow"])).max() < 1e-2
    assert d_img.mean() < 1e-4
    assert d_img.max() < 1e-3
    assert dbg_t.keys() == dbg_j.keys()
    assert kernel_counts() == (0,) * 7
