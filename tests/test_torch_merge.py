"""The port's kernel estimation and merge (K5) against the JAX package.

``estimate_kernels`` and the merges' num/den within 1e-5 relative.
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


@pytest.mark.parametrize("ts,scale", [(16, 2), (32, 2), (16, 3), (8, 1)])
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


def test_cpu_wrapper_launches_no_kernel(frames):
    _, comp = frames
    num, den = torch.zeros(3, 2 * H, 2 * W), torch.zeros(3, 2 * H, 2 * W)
    covs = torch.eye(2)[[0, 0, 1], [0, 1, 1]][:, None, None].expand(3, H // 2, W // 2)
    cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                torch.ones(H, W), num, den, DEFAULT_CFA, 16, 2)
    assert kernel_counts() == (0,) * 5
    assert float(den.sum()) > 0
    with pytest.raises(ValueError):      # accumulators of the wrong size
        cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                    torch.ones(H, W), num[:, :-1], den, DEFAULT_CFA, 16, 2)
