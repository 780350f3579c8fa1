"""The port's kernel estimation and merges (K5, K5') against the JAX package.

``estimate_kernels`` and the merges' num/den within 1e-5 relative; K5''s
plain version against the JAX burst-fused Pallas merge within 1e-6, and
against K5's plain version exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import kernel_counts, rel_err, small_config, t  # noqa: E402

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models import kernels as j_kernels  # noqa: E402
from hmsr_tpu.models import merge_tiled as j_merge  # noqa: E402
from hmsr_tpu_torch.models import kernels, merge_tiled  # noqa: E402
from hmsr_tpu_torch.ops import cuda_merge  # noqa: E402

H, W = 64, 96


@pytest.fixture(scope="module")
def frames():
    ref, comps, _, _ = make_synthetic_burst(H, W, n_frames=2, seed=4)
    return ref, comps[0]


@pytest.mark.parametrize("law", ["linear", "hard_threshold"])
def test_estimate_kernels(frames, law):
    _, comp = frames
    config = small_config(128)
    config.merging.selection_law = law
    got = kernels.estimate_kernels(t(comp), config)
    want = j_kernels.estimate_kernels(jnp.asarray(comp), config)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("ts,scale", [(16, 2), (32, 2), (16, 3), (8, 1), (64, 2),
                                      (32, 3), (16, 1), (32, 1), (64, 1), (64, 3)])
def test_merge_tiled(frames, ts, scale):
    """Flows with negative fractions (covariance extrapolation at index -1),
    exact halves, and tiles pushed out of the frame (ok_tile)."""
    ref, comp = frames
    config = small_config(128, ts)
    config.scale = scale
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(comp), config))
    rng = np.random.RandomState(ts + scale)
    flow = rng.uniform(-2.5, 2.5, (-(-H // ts), -(-W // ts), 2)).astype(np.float32)
    flow[0, 0] = (-0.75, -0.25)
    flow[0, 1] = (0.5, -1.5)
    flow[-1, -1] = (-40.0, 35.0)
    r = rng.rand(H, W).astype(np.float32)
    num = rng.rand(3, H * scale, W * scale).astype(np.float32)
    den = rng.rand(3, H * scale, W * scale).astype(np.float32)
    want = j_merge.merge_tiled(jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(covs),
                               jnp.asarray(r), jnp.asarray(num), jnp.asarray(den),
                               DEFAULT_CFA, config)
    num_t, den_t = t(num), t(den)
    got = merge_tiled.merge_tiled(t(comp), t(flow), t(covs), t(r), num_t, den_t,
                                  DEFAULT_CFA, config)
    assert got[0] is num_t and got[1] is den_t          # accumulated in place
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_merge_ref_tiled(frames, scale):
    ref, _ = frames
    config = small_config(128)
    config.scale = scale
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(ref), config))
    rng = np.random.RandomState(scale)
    num = rng.rand(3, H * scale, W * scale).astype(np.float32)
    den = rng.rand(3, H * scale, W * scale).astype(np.float32)
    want = j_merge.merge_ref_tiled(jnp.asarray(ref), jnp.asarray(covs), jnp.asarray(num),
                                   jnp.asarray(den), DEFAULT_CFA, config)
    got = merge_tiled.merge_ref_tiled(t(ref), t(covs), t(num), t(den), DEFAULT_CFA, config,
                                      band_rows=40)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5


def test_unported_branches_raise(frames):
    ref, _ = frames
    config = small_config(128)
    z = torch.zeros(3, 2 * H, 2 * W)
    with pytest.raises(NotImplementedError):
        merge_tiled.merge_ref_tiled(t(ref), torch.ones(3, H // 2, W // 2), z, z,
                                    DEFAULT_CFA, config, acc_rob=torch.zeros(H, W))
    config.merging.kernel = "iso"
    with pytest.raises(NotImplementedError):
        merge_tiled.merge_ref_tiled(t(ref), torch.ones(3, H // 2, W // 2), z, z,
                                    DEFAULT_CFA, config)


def _burst_inputs(seed, F, h, w, ts):
    """``tests/test_pallas_merge.py:_burst_inputs`` (Bayer)."""
    rng = np.random.RandomState(seed)
    ny, nx = -(-h // ts), -(-w // ts)
    comp = rng.rand(F, h, w).astype(np.float32)
    flow = (rng.rand(F, ny, nx, 2) * 2 - 1).astype(np.float32) * 5.0
    r = rng.rand(F, h, w).astype(np.float32)
    gg = rng.rand(F, h // 2, w // 2, 2).astype(np.float32) + 0.3
    cov = np.stack([gg[..., 0], 0.2 * np.sqrt(gg[..., 0] * gg[..., 1]),
                    gg[..., 1]], axis=1).astype(np.float32)
    return comp, flow, cov, r


def test_merge_burst_against_jax_burst_pallas():
    """K5''s plain version (through its wrapper on CPU tensors) against the
    JAX burst-fused Pallas merge in interpret mode, at the shapes of
    ``test_pallas_merge.py:test_burst_fused_matches_sequential`` (F=4,
    32x128, Ts=16, x2), the padded accumulators cropped to the image.
    Tolerance 1e-6 relative: the Pallas kernel evaluates the same per-pixel
    arithmetic on its slab layout with other association orders, so the two
    differ in the last bits of float32 (about 2e-7 relative here), not more.
    """
    from hmsr_tpu.configs import default_config, update_snr_config
    from hmsr_tpu.ops.pallas_merge import merge_burst_pallas, padded_accum_shape
    seed, F, h, w, ts, s = 23, 4, 32, 128, 16, 2
    config = default_config()
    config.scale = s
    update_snr_config(config, 20)
    config.block_matching.tuning.tile_size = ts
    comp, flow, cov, r = _burst_inputs(seed, F, h, w, ts)
    rng = np.random.RandomState(seed)
    pad = padded_accum_shape(config, (h, w), 3)
    num0 = rng.rand(*pad).astype(np.float32)
    den0 = rng.rand(*pad).astype(np.float32)
    want = merge_burst_pallas(jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(cov),
                              jnp.asarray(r), jnp.asarray(num0), jnp.asarray(den0),
                              DEFAULT_CFA, config, interpret=True)
    num, den = t(num0[:, :s * h, :s * w]), t(den0[:, :s * h, :s * w])
    got = cuda_merge.merge_burst_accumulate(t(comp), t(flow), t(cov), t(r), num, den,
                                            DEFAULT_CFA, ts, s)
    assert got[0] is num and got[1] is den          # accumulated in place
    for g, wnt in zip(got, want):
        assert rel_err(g, np.asarray(wnt)[:, :s * h, :s * w]) <= 1e-6
    assert kernel_counts() == (0,) * 6


@pytest.mark.parametrize("F,ts,scale", [
    (3, 16, 2), (2, 32, 2), (4, 16, 3), (2, 64, 2), (2, 16, 1), (2, 32, 1),
    (2, 64, 1), (2, 32, 3), (2, 64, 3)])
def test_merge_burst_equals_sequential_frames(F, ts, scale):
    """K5''s plain version is F plain K5 merges in frame order, bit for
    bit (the property K5' holds against K5 on the card), at every (Ts,
    scale) the kernels are checked at on the card."""
    h, w = 64, 96
    comp, flow, cov, r = _burst_inputs(F + ts, F, h, w, ts)
    flow[0, 0, 0] = (-40.0, 35.0)                   # a clipped tile (ok_tile)
    rng = np.random.RandomState(ts)
    num0 = rng.rand(3, scale * h, scale * w).astype(np.float32)
    den0 = rng.rand(3, scale * h, scale * w).astype(np.float32)
    n_b, d_b = t(num0), t(den0)
    cuda_merge.merge_burst_plain(t(comp), t(flow), t(cov), t(r), n_b, d_b,
                                 DEFAULT_CFA, ts, scale)
    n_s, d_s = t(num0), t(den0)
    for f in range(F):
        cuda_merge.merge_plain(t(comp[f]), t(flow[f]), t(cov[f]), t(r[f]), n_s, d_s,
                               DEFAULT_CFA, ts, scale)
    assert torch.equal(n_b, n_s) and torch.equal(d_b, d_s)
    assert not torch.equal(n_b, t(num0))


def test_merge_burst_wrapper_checks():
    comp, flow, cov, r = _burst_inputs(1, 3, 64, 96, 16)
    num, den = torch.zeros(3, 128, 192), torch.zeros(3, 128, 192)
    with pytest.raises(ValueError):      # stacks of different lengths
        cuda_merge.merge_burst_accumulate(t(comp), t(flow[:2]), t(cov), t(r), num, den,
                                          DEFAULT_CFA, 16, 2)
    with pytest.raises(ValueError):      # one frame where a stack is expected
        cuda_merge.merge_burst_accumulate(t(comp[0]), t(flow[0]), t(cov[0]), t(r[0]),
                                          num, den, DEFAULT_CFA, 16, 2)
    with pytest.raises(ValueError):      # flow tiles that do not cover the frame
        cuda_merge.merge_burst_accumulate(t(comp), t(flow), t(cov), t(r), num, den,
                                          DEFAULT_CFA, 8, 2)
    assert kernel_counts() == (0,) * 6


def test_cpu_wrapper_launches_no_kernel(frames):
    _, comp = frames
    num, den = torch.zeros(3, 2 * H, 2 * W), torch.zeros(3, 2 * H, 2 * W)
    covs = torch.eye(2)[[0, 0, 1], [0, 1, 1]][:, None, None].expand(3, H // 2, W // 2)
    cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                torch.ones(H, W), num, den, DEFAULT_CFA, 16, 2)
    assert kernel_counts() == (0,) * 6
    assert float(den.sum()) > 0
    with pytest.raises(ValueError):      # accumulators of the wrong size
        cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                    torch.ones(H, W), num[:, :-1], den, DEFAULT_CFA, 16, 2)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_scale_divisor_divides(scale):
    """The plain merges divide HR coordinates by the scale as the JAX
    package and the kernels do: one rounding (at s=3 a multiplication by
    the rounded reciprocal differs for a third of the values)."""
    x = torch.arange(0, 30000, dtype=torch.float32) + 0.5
    got = (x / cuda_merge.scale_divisor(scale, x.device)).numpy()
    np.testing.assert_array_equal(got, x.numpy() / np.float32(scale))
    assert got.dtype == np.float32
