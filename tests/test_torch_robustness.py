"""The port's robustness stage (K4 upscale-warp) against the JAX package.

Warp stats within 1e-5 and validity masks exact, including flows large
enough to clip a tile's window origin (``ok_tile``).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import (WB, curves, default_config, kernel_counts,  # noqa: E402
                                max_abs, n, small_config, t)

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models import robustness as j_rob  # noqa: E402
from hmsr_tpu_torch.convert import from_numpy  # noqa: E402
from hmsr_tpu_torch.models import robustness  # noqa: E402
from hmsr_tpu_torch.ops import cuda_warp  # noqa: E402


@pytest.fixture(scope="module")
def burst():
    ref, comps, _, _ = make_synthetic_burst(96, 128, n_frames=2, seed=3)
    return ref, comps[0]


def _flow(seed, ny, nx, big=True):
    fl = np.random.RandomState(seed).uniform(-3, 3, (ny, nx, 2)).astype(np.float32)
    fl[0, 0] = (-0.5, 0.5)                 # floor(f + 0.5) at exact halves
    if big:
        fl[0, 1:3] = (-40.0, 7.5)          # window origin clipped: whole tile invalid
        fl[-1, -2:] = (33.0, 41.0)
    return fl


def test_compute_guide_image(burst):
    ref, _ = burst
    wb = [2.0, 1.0, 1.5]
    assert max_abs(robustness.compute_guide_image(t(ref), DEFAULT_CFA, wb),
                   j_rob.compute_guide_image(jnp.asarray(ref), DEFAULT_CFA, wb,
                                             impl="slices")) <= 1e-5


@pytest.mark.parametrize("ts,big,u,c", [
    pytest.param(16, True, 2, 3, id="16-True"), pytest.param(32, True, 2, 3, id="32-True"),
    pytest.param(16, False, 2, 3, id="16-False"), pytest.param(8, True, 2, 3, id="8-True"),
    pytest.param(64, True, 2, 3, id="64-True"),
    pytest.param(16, True, 1, 1, id="16-True-grey"),
    pytest.param(6, True, 3, 3, id="6-True-u3")])
def test_upscale_warp_stats_tiled(ts, big, u, c):
    """The main path's call (3 channels, x2), grey mode's (1 channel, no
    upscale), and an upscale whose reciprocal is inexact."""
    lh, lw = 96 // u, 128 // u
    H, W = u * lh, u * lw
    st = np.random.RandomState(ts).rand(c, lh, lw).astype(np.float32)
    flow = _flow(ts + 1, -(-H // ts), -(-W // ts), big)
    got, gv = robustness.upscale_warp_stats_tiled(t(st), u, ts, t(flow), (H, W))
    want, wv = j_rob.upscale_warp_stats_tiled(jnp.asarray(st), u, ts, jnp.asarray(flow),
                                              (H, W))
    np.testing.assert_array_equal(n(gv), np.asarray(wv))
    if big:
        assert not n(gv).all()
    assert max_abs(got, want) <= 1e-5


def test_init_robustness(burst):
    ref, _ = burst
    config = small_config(128)
    std, diff = curves()
    got = robustness.init_robustness(t(ref), DEFAULT_CFA, WB, (t(std), t(diff)), config)
    want = j_rob.init_robustness(jnp.asarray(ref), DEFAULT_CFA, WB,
                                 (jnp.asarray(std), jnp.asarray(diff)), config)
    for g, w in zip(got, want):
        assert max_abs(g.float(), np.asarray(w).astype(np.float32)) <= 1e-5


@pytest.mark.parametrize("cfg", ["small", "default"])
def test_compute_robustness(burst, cfg):
    """From the JAX reference stats carried over, so that the stage is
    compared in isolation."""
    ref, comp = burst
    config = small_config(128) if cfg == "small" else default_config(256)
    ts = config.block_matching.tuning.tile_size
    std, diff = curves()
    j_stats = j_rob.init_robustness(jnp.asarray(ref), DEFAULT_CFA, WB,
                                    (jnp.asarray(std), jnp.asarray(diff)), config)
    flow = _flow(9, -(-96 // ts), -(-128 // ts), big=False)
    want = j_rob.compute_robustness(jnp.asarray(comp), j_stats, jnp.asarray(flow),
                                    DEFAULT_CFA, WB, config)
    p_stats = from_numpy(jax.tree_util.tree_map(np.asarray, j_stats), "cpu")
    assert isinstance(p_stats, robustness.RefStats)
    got = robustness.compute_robustness(t(comp), p_stats, t(flow), DEFAULT_CFA, WB, config)
    assert max_abs(got, want) <= 1e-5


def test_compute_s():
    flow = _flow(10, 7, 9, big=False)
    flow[3, 4] = (2.0, -1.0)
    assert max_abs(robustness.compute_s(t(flow), 0.8, 2, 12),
                   j_rob.compute_s(jnp.asarray(flow), 0.8, 2, 12)) == 0.0


def test_robustness_disabled(burst):
    ref, comp = burst
    config = small_config(128)
    config.robustness.enabled = False
    assert robustness.init_robustness(t(ref), DEFAULT_CFA, WB, None, config) is None
    r = robustness.compute_robustness(t(comp), None, torch.zeros(6, 8, 2), DEFAULT_CFA,
                                      WB, config)
    assert bool((r == 1).all())


def test_cpu_wrapper_launches_no_kernel():
    st = torch.rand(3, 8, 8)
    cuda_warp.upscale_warp(st, 2, 16, torch.zeros(1, 1, 2), (16, 16))
    assert kernel_counts() == (0,) * 8
    with pytest.raises(ValueError):   # flow does not cover the output
        cuda_warp.upscale_warp(st, 2, 8, torch.zeros(1, 1, 2), (16, 16))
