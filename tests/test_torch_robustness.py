"""The port's robustness stage (K4 upscale-warp, K10's plain version)
against the JAX package.

Warp stats within 1e-5 and validity masks exact, including flows large
enough to clip a tile's window origin (``ok_tile``); the map of a compared
frame within 1e-5 per tile size, mode and border flow; K10's wrapper checks
and launch layout.
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
from hmsr_tpu_torch.ops import cuda_robustness, cuda_warp  # noqa: E402


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


def _stats_and_flow(burst, ts, grey, big):
    """The JAX reference's statistics of ``burst`` (and the port's copy) and
    a flow at tile size ``ts``, in Bayer or grey mode."""
    ref, _ = burst
    config = small_config(128, ts)
    config.mode = "grey" if grey else "bayer"
    std, diff = curves()
    j_stats = j_rob.init_robustness(jnp.asarray(ref), DEFAULT_CFA, WB,
                                    (jnp.asarray(std), jnp.asarray(diff)), config)
    p_stats = from_numpy(jax.tree_util.tree_map(np.asarray, j_stats), "cpu")
    return config, j_stats, p_stats, _flow(ts + 7, -(-96 // ts), -(-128 // ts), big)


@pytest.mark.parametrize("big", [False, True], ids=["flow", "border-flow"])
@pytest.mark.parametrize("grey", [False, True], ids=["bayer", "grey"])
@pytest.mark.parametrize("ts", [16, 32, 64])
def test_robustness_plain(burst, ts, grey, big):
    """K10's plain version (what CPU tensors run) against the JAX package's
    ``compute_robustness``; at Ts=64 the 96x128 frame is no multiple of Ts,
    and border flows push tiles out of the grid. 2e-5: R = S exp(-d_sq /
    sigma^2) - t with S = 12 magnifies the two packages' float32 roundings of
    the warp and the exponential (largest gap seen 1.03e-5, Ts=32 grey)."""
    _, comp = burst
    config, j_stats, p_stats, flow = _stats_and_flow(burst, ts, grey, big)
    want = j_rob.compute_robustness(jnp.asarray(comp), j_stats, jnp.asarray(flow),
                                    DEFAULT_CFA, WB, config)
    tun = config.robustness.tuning
    got = cuda_robustness.robustness_fused(t(comp), p_stats, t(flow), DEFAULT_CFA, WB, grey,
                                           ts, tun.Mt, tun.s1, tun.s2, tun.t)
    assert max_abs(got, want) <= 2e-5
    assert (n(got) == 0).any() and (n(got) > 0).any()
    if big:
        assert (n(got)[:2] == 0).any()        # the clipped tiles' pixels


def test_compute_robustness_runs_k10_plain(burst):
    """``compute_robustness`` hands CPU tensors to K10's plain version and
    launches nothing."""
    _, comp = burst
    config, _, p_stats, flow = _stats_and_flow(burst, 16, False, True)
    tun = config.robustness.tuning
    got = robustness.compute_robustness(t(comp), p_stats, t(flow), DEFAULT_CFA, WB, config)
    want = cuda_robustness.robustness_plain(t(comp), p_stats, t(flow), DEFAULT_CFA, WB,
                                            False, 16, tun.Mt, tun.s1, tun.s2, tun.t)
    assert bool(torch.equal(got, want))
    assert cuda_robustness.robustness_fused.launches == 0


def _fault(name, comp, stats, flow):
    """One input K10's wrapper refuses, and the rest as given."""
    ts, cfa, grey = 16, DEFAULT_CFA, False
    if name == "dtype":
        comp = comp.double()
    elif name == "shape":
        comp = comp[None]
    elif name == "stats-shape":
        stats = stats._replace(means=stats.means[:, :-2])
    elif name == "valid-dtype":
        stats = stats._replace(valid=stats.valid.float())
    elif name == "flow-cover":
        flow = flow[:-1]
    elif name == "contiguity":
        comp = comp.t().contiguous().t()
    elif name == "tile-size":
        ts = 5
    elif name == "cfa":
        cfa = np.array([[0, 1], [1, 1]])
    return comp, stats, flow, cfa, WB, grey, ts


@pytest.mark.parametrize("name", ["dtype", "shape", "stats-shape", "valid-dtype",
                                  "flow-cover", "contiguity", "tile-size", "cfa"])
def test_robustness_wrapper_checks(burst, name):
    _, comp = burst
    config, _, p_stats, flow = _stats_and_flow(burst, 16, False, False)
    tun = config.robustness.tuning
    args = _fault(name, t(comp), p_stats, t(flow))
    with pytest.raises(ValueError):
        cuda_robustness.robustness_fused(*args, tun.Mt, tun.s1, tun.s2, tun.t)


@pytest.mark.parametrize("grey", [False, True], ids=["bayer", "grey"])
@pytest.mark.parametrize("ts", [16, 32, 64])
def test_robustness_layout_main_paths(ts, grey):
    """The main paths' tile sizes have instantiations of their own and a
    region of 32 x 64 pixels (one tile where Ts is larger), within the
    shared memory that leaves three blocks an SM."""
    lay = cuda_robustness.robustness_layout(ts, grey)
    assert lay["fixed"] and lay["threads"] == cuda_robustness.ROB_THREADS
    assert lay["tiles_y"] * ts == max(ts, 32) and lay["tiles_x"] * ts == max(ts, 64)
    assert lay["smem_bytes"] <= 227 * 1024 // 3


@pytest.mark.parametrize("ts,grey", [(2, False), (2, True), (4, False), (6, False),
                                     (6, True), (8, False), (12, True), (128, False)])
def test_robustness_layout_run_time(ts, grey):
    """Other tile sizes take the run-time instantiation, within
    ROB_SMEM_MAX (a small Ts halves its region until it fits; a Ts over 64
    is one tile a block) and the 227 KB a block may have."""
    lay = cuda_robustness.robustness_layout(ts, grey)
    assert not lay["fixed"]
    assert lay["smem_bytes"] <= cuda_robustness.ROB_SMEM_MAX or \
        (ts > 64 and (lay["tiles_y"], lay["tiles_x"]) == (1, 1))
    assert lay["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("ts,grey", [(1, True), (0, False), (7, False)])
def test_robustness_layout_refusals(ts, grey):
    with pytest.raises(ValueError):
        cuda_robustness.robustness_layout(ts, grey)


def test_cfa_code():
    """Phase 2 i + j's channel at bit 2 (2 i + j)."""
    assert cuda_robustness.cfa_code(np.array([[0, 1], [1, 2]])) == \
        0 + (1 << 2) + (1 << 4) + (2 << 6)
    assert cuda_robustness.cfa_code([[1, 2], [0, 1]]) == 1 + (2 << 2) + 0 + (1 << 6)
