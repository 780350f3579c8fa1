"""The port's alignment (K1 block matching, K2 ICA steps, K3 fused ICA)
against the JAX package.

Block-matching displacements must agree exactly; ICA flows within 1e-4.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import default_config, kernel_counts, max_abs, n, small_config, t  # noqa: E402,E501

from hmsr_tpu.models import alignment as j_align  # noqa: E402
from hmsr_tpu.models import block_matching as j_bm  # noqa: E402
from hmsr_tpu.models import ica as j_ica  # noqa: E402
from hmsr_tpu_torch.convert import from_numpy  # noqa: E402
from hmsr_tpu_torch.models import alignment, block_matching, ica  # noqa: E402


def _pair(seed, h, w, shift=(2, 3), noise=0.02):
    """A smooth-ish random scene and a shifted, noisy copy of it."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4 + 4, w // 4 + 4).astype(np.float32)
    scene = np.kron(base, np.ones((4, 4), np.float32))
    dy, dx = shift
    ref = scene[4:4 + h, 4:4 + w] + noise * rng.randn(h, w).astype(np.float32)
    mov = scene[4 + dy:4 + dy + h, 4 + dx:4 + dx + w] + noise * rng.randn(h, w).astype(np.float32)
    return ref.astype(np.float32), mov.astype(np.float32), rng


def _tiles(a, ts):
    h, w = a.shape
    ny, nx = h // ts, w // ts
    return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("fill", [None, 0.0])
def test_extract_flow_patches(fill):
    ref, mov, rng = _pair(0, 48, 64)
    flow = rng.uniform(-9, 9, (3, 4, 2)).astype(np.float32)
    flow[0, 0] = (-70.0, 60.0)
    got = block_matching.extract_flow_patches(t(mov), t(flow), 16, 4, fill=fill)
    want = j_bm.extract_flow_patches(jnp.asarray(mov), jnp.asarray(flow), 16, 4, fill=fill)
    assert max_abs(got, want) == 0.0


@pytest.mark.parametrize("ts", [8, 16, 32, 64])
def test_match_l2_exact(ts):
    """L2 r=4: edge-clamped windows, displacement added to the unrounded flow."""
    ref, mov, rng = _pair(1, 4 * ts, 5 * ts)
    ny, nx = 4, 5
    flow = rng.uniform(-3, 3, (ny, nx, 2)).astype(np.float32)
    flow[0, 1] = (2.5, -1.5)                  # half-to-even window origins
    flow[0, 2] = (1.0, -2.0)                  # window rows clamped at the top
    # (windows clamped as a whole make every candidate tie exactly; the JAX
    # twin's integral-image window norms then round differently per
    # candidate, so such tiles are left to the kernel-vs-plain check)
    got = block_matching.match_l2(t(_tiles(ref, ts)), t(mov), t(flow), ts, 4)
    want = j_bm.match_l2(jnp.asarray(_tiles(ref, ts)), jnp.asarray(mov),
                         jnp.asarray(flow), ts, 4)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("ts", [8, 16, 32, 64])
def test_match_l1_exact(ts):
    """L1 r=1: zero-filled windows, flow replaced by round(flow) + d."""
    ref, mov, rng = _pair(2, 4 * ts, 5 * ts, shift=(1, -1))
    flow = rng.uniform(-2, 2, (4, 5, 2)).astype(np.float32)
    flow[0, 0] = (-0.5, 1.5)
    flow[1, 2] = (-30.0, 2.0)                 # fully out of bounds: all-zero window
    got = block_matching.match_l1(t(ref), t(mov), t(flow), ts, 1)
    want = j_bm.match_l1(jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(flow), ts, 1)
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_refine_ica(ts):
    """Gauss-Newton steps including negative fractional flows (trunc toward
    zero) and windows partly out of bounds (zero taps)."""
    ref, mov, rng = _pair(3, 4 * ts, 4 * ts, shift=(1, 1), noise=0.005)
    ref_g = jnp.asarray(ref)
    flow = rng.uniform(-2.5, 2.5, (4, 4, 2)).astype(np.float32)
    flow[0, 0] = (-1.75, -0.25)
    j_state = j_ica.init_ica(ref_g, ts)
    want = j_ica.refine_ica_tiled(ref_g, j_state, jnp.asarray(mov), jnp.asarray(flow), ts, 3)
    p_state = ica.init_ica(t(ref), ts)
    for a, b in zip(p_state, j_state):
        assert max_abs(a, b) <= 1e-5 * max(1.0, float(np.max(np.abs(b))))
    got = ica.refine_ica_tiled(t(ref), p_state, t(mov), t(flow), ts, 3)
    assert max_abs(got, want) <= 1e-4
    # the same step from the JAX package's own reference state
    got2 = ica.refine_ica_tiled(t(ref), from_numpy(jax.tree_util.tree_map(np.asarray, j_state),
                                                   "cpu"), t(mov), t(flow), ts, 3)
    assert max_abs(got2, want) <= 1e-4


def test_singular_tiles_keep_their_flow():
    """Tiles with |det H| < 1e-10 (flat reference) keep the input flow."""
    ts = 16
    ref = np.zeros((32, 32), np.float32)
    ref[16:, 16:] = np.random.RandomState(4).rand(16, 16)
    mov = np.roll(ref, 1, axis=1)
    flow = np.full((2, 2, 2), 0.25, np.float32)
    got = n(ica.refine_ica_tiled(t(ref), ica.init_ica(t(ref), ts), t(mov), t(flow), ts, 3))
    np.testing.assert_array_equal(got[0, 0], flow[0, 0])
    want = j_ica.refine_ica_tiled(jnp.asarray(ref), j_ica.init_ica(jnp.asarray(ref), ts),
                                  jnp.asarray(mov), jnp.asarray(flow), ts, 3)
    assert max_abs(got, want) <= 1e-4


@pytest.mark.parametrize("ts,bm,jax_ref", [(8, True, "tiled"), (16, True, "tiled"),
                                           (32, True, "interpret"), (8, False, "tiled"),
                                           (16, False, "interpret")])
def test_refine_ica_fused(ts, bm, jax_ref):
    """K3's plain version against the JAX package, with and without the L1
    radius-1 search: half-integer flows (round half to even), negative
    fractions, a window fully out of bounds and a singular tile. The JAX
    side is its fused kernel (``pallas_ica_fused``) in interpret mode, as its
    own tests run it, or the per-step path that kernel folds together
    (``match_l1`` + ``refine_ica_tiled``), which its tests hold the kernel
    to. Flows within 1e-4; the search alone gives match_l1's flows exactly."""
    from hmsr_tpu.ops import pallas_ica_fused as j_fused
    ref, mov, rng = _pair(8, 3 * ts, 4 * ts, shift=(1, -1), noise=0.005)
    ref[:ts, :ts] = 0.0                        # flat tile: |det| < 1e-10
    flow = rng.uniform(-2.5, 2.5, (3, 4, 2)).astype(np.float32)
    flow[0, 1] = (0.5, -1.5)
    flow[1, 2] = (-1.75, -0.25)
    flow[2, 3] = (-40.0, 3.0)                  # window fully out of bounds
    ref_g, mov_g, flow_g = jnp.asarray(ref), jnp.asarray(mov), jnp.asarray(flow)
    j_state = j_ica.init_ica(ref_g, ts)
    if jax_ref == "tiled":
        start = j_bm.match_l1(ref_g, mov_g, flow_g, ts, 1) if bm else flow_g
        want = j_ica.refine_ica_tiled(ref_g, j_state, mov_g, start, ts, 3)
    elif bm:
        want = j_fused.match_l1_refine_ica_fused(ref_g, j_state, mov_g, flow_g, ts, 3,
                                                 interpret=True)
    else:
        want = j_fused.refine_ica_pallas(ref_g, j_state, mov_g, flow_g, ts, 3,
                                         interpret=True)
    p_state = ica.init_ica(t(ref), ts)
    got = ica.refine_ica_fused(t(ref), p_state, t(mov), t(flow), ts, 3, bm=bm)
    assert max_abs(got, want) <= 1e-4
    # the fused form equals the per-step form it folds together
    start = block_matching.match_l1(t(ref), t(mov), t(flow), ts, 1) if bm else t(flow)
    steps = ica.refine_ica_tiled(t(ref), p_state, t(mov), start, ts, 3)
    assert max_abs(got, steps) == 0.0
    if bm:
        np.testing.assert_array_equal(n(ica.refine_ica_fused(t(ref), p_state, t(mov), t(flow),
                                                             ts, 0, bm=True)),
                                      np.asarray(j_bm.match_l1(ref_g, mov_g, flow_g, ts, 1)))


@pytest.mark.parametrize("cfg", ["small16", "small32"])
def test_align(cfg):
    """Whole descent: init_alignment + align (K1 and n_iter K2 steps per
    level, or K3 on levels under FUSED_GN_MAX_TILES tiles).
    The 4-level tuning (Ts/2 coarsest level, nearest flow upscale) is held
    end to end in test_torch_pipeline."""
    size, config = 128, small_config(128, int(cfg[-2:]))
    ref, mov, _ = _pair(5, size, size, shift=(2, -3), noise=0.01)
    j_state = j_align.init_alignment(jnp.asarray(ref), config)
    want = j_align.align(j_state, jnp.asarray(mov), config)

    p_state = alignment.init_alignment(t(ref), config)
    for a, b in zip(p_state.pyramid, j_state.pyramid):
        assert max_abs(a, b) <= 1e-5
    for a, b in zip(p_state.tiles, j_state.tiles):
        assert max_abs(a, b) <= 1e-5
    got = alignment.align(p_state, t(mov), config)
    assert max_abs(got, want) <= 1e-4
    # from the JAX reference state carried over
    conv = from_numpy(jax.tree_util.tree_map(np.asarray, j_state), "cpu")
    assert isinstance(conv, alignment.AlignmentRefState)
    assert max_abs(alignment.align(conv, t(mov), config), want) <= 1e-4


def test_upscale_flow():
    """Between the levels of the ``bench.py`` configuration (re-tiled by 2
    and 4, zero-padded to the level's tiles): nearest exactly, bilinear and
    bicubic (``jax.image.resize``'s rule, ops/resize.py) within 1e-5."""
    config = default_config(256)
    flow = np.random.RandomState(6).uniform(-2, 2, (3, 4, 2)).astype(np.float32)
    for mode, tol in (("nearest", 0.0), ("bilinear", 1e-5), ("bicubic", 1e-5)):
        config.block_matching.tuning.flow_upscale_mode = mode
        for list_id, npatches in ((2, (13, 17)), (1, (12, 16)), (0, (7, 8))):
            got = alignment.upscale_flow(t(flow), npatches, list_id, config)
            want = j_align.upscale_flow(jnp.asarray(flow), npatches, list_id, config)
            assert max_abs(got, want) <= tol, (mode, list_id)


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the K1/K2/K3 wrappers run their plain versions."""
    from hmsr_tpu_torch.ops import cuda_ica
    before = kernel_counts()
    ref, mov, _ = _pair(7, 32, 32)
    flow = torch.zeros((2, 2, 2))
    cuda_ica.block_match(t(_tiles(ref, 16)), t(mov), flow, 16, 4, "L2")
    st = ica.init_ica(t(ref), 16)
    cuda_ica.ica_steps(t(ref), st.gradx, st.grady, st.terms, t(mov), flow, 16, 3)
    for bm in (False, True):
        cuda_ica.ica_fused(t(ref), st.gradx, st.grady, st.terms, t(mov), flow, 16, 3, bm)
    assert kernel_counts() == before == (0,) * 7
    with pytest.raises(ValueError):
        cuda_ica.block_match(t(_tiles(ref, 16)), t(mov), flow.double(), 16, 4, "L2")
