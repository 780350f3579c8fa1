"""The port's Gauss-Newton steps (K2 ``ica_steps``, the steps of K3) and the
per-burst solve terms against the JAX package.

Flows within 1e-4 of the JAX ``refine_ica_tiled``; the plain versions equal
the per-step loop they fold together bit for bit.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import kernel_counts, max_abs, n, t  # noqa: E402

from hmsr_tpu.models import ica as j_ica  # noqa: E402
from hmsr_tpu_torch.convert import from_numpy  # noqa: E402
from hmsr_tpu_torch.models import ica  # noqa: E402
from hmsr_tpu_torch.ops import cuda_ica  # noqa: E402


def _level(ts, seed=0, ny=3, nx=4):
    """A blocky noisy scene, its shifted copy and flows with negative
    fractions, a window fully out of bounds and a singular tile (0, 0):
    the reference is flat over the tile and the pixel row and column after
    it, so its gradients, Hessian and det vanish."""
    rng = np.random.RandomState(seed)
    h, w = ny * ts, nx * ts
    base = rng.rand(h // 4 + 4, w // 4 + 4).astype(np.float32)
    scene = np.kron(base, np.ones((4, 4), np.float32))
    ref = scene[2:2 + h, 2:2 + w] + 0.005 * rng.randn(h, w).astype(np.float32)
    mov = scene[3:3 + h, 1:1 + w] + 0.005 * rng.randn(h, w).astype(np.float32)
    ref[:ts + 1, :ts + 1] = 0.0
    flow = rng.uniform(-2.5, 2.5, (ny, nx, 2)).astype(np.float32)
    flow[0, 1] = (-1.75, -0.25)                # negative fractions
    flow[1, 2] = (0.5, -1.5)
    flow[2, 3] = (-40.0, 3.0)                  # window fully out of bounds
    return ref.astype(np.float32), mov.astype(np.float32), flow


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("ts", [8, 16, 32, 64])
def test_ica_steps_plain(ts, n_iter):
    """K2's plain version against the JAX ``refine_ica_tiled`` (1e-4) and
    against the per-step loop of ``ica_step_plain`` + ``gn_update`` (bit for
    bit); the singular tile keeps its flow exactly; the CPU wrapper and
    ``refine_ica_tiled`` run the plain version and launch nothing."""
    ref, mov, flow = _level(ts, seed=ts + n_iter)
    ref_g = jnp.asarray(ref)
    want = j_ica.refine_ica_tiled(ref_g, j_ica.init_ica(ref_g, ts), jnp.asarray(mov),
                                  jnp.asarray(flow), ts, n_iter)
    st = ica.init_ica(t(ref), ts)
    assert float(st.terms[0, 0, 0]) == 0.0     # det_inv of the singular tile
    args = (t(ref), st.gradx, st.grady, st.terms, t(mov), t(flow), ts, n_iter)
    got = cuda_ica.ica_steps_plain(*args)
    assert max_abs(got, want) <= 1e-4
    np.testing.assert_array_equal(n(got)[0, 0], flow[0, 0])
    fl = t(flow)
    for _ in range(n_iter):
        fl = cuda_ica.gn_update(fl, cuda_ica.ica_step_plain(t(ref), st.gradx, st.grady,
                                                            t(mov), fl, ts), st.terms)
    assert torch.equal(got, fl)
    before = kernel_counts()
    assert torch.equal(cuda_ica.ica_steps(*args), got)
    assert torch.equal(ica.refine_ica_tiled(t(ref), st, t(mov), t(flow), ts, n_iter), got)
    assert kernel_counts() == before == (0,) * 7


@pytest.mark.parametrize("ts", [8, 16])
def test_fused_without_search_equals_steps(ts):
    """K3's plain version without the search is K2's, bit for bit (the
    kernels share their steps and are held to that on the card)."""
    ref, mov, flow = _level(ts, seed=7)
    st = ica.init_ica(t(ref), ts)
    args = (t(ref), st.gradx, st.grady, st.terms, t(mov), t(flow), ts, 3)
    assert torch.equal(cuda_ica.ica_fused_plain(*args, False), cuda_ica.ica_steps_plain(*args))


@pytest.mark.parametrize("source", ["init_ica", "from_jax"])
def test_state_carries_solve_terms(source):
    """The reference state carries ``solve_terms(hessian)``: computed by
    ``init_ica``, or derived by ``from_numpy`` from the Hessian of the JAX
    package's state, which has no such field."""
    ref, _, _ = _level(16, seed=3)
    if source == "init_ica":
        st = ica.init_ica(t(ref), 16)
    else:
        j_state = jax.tree_util.tree_map(np.asarray, j_ica.init_ica(jnp.asarray(ref), 16))
        assert not hasattr(j_state, "terms")
        st = from_numpy(j_state, "cpu")
    assert isinstance(st, ica.IcaRefState)
    assert tuple(st.terms.shape) == (3, 4, 5) and st.terms.dtype == torch.float32
    assert torch.equal(st.terms, cuda_ica.solve_terms(st.hessian))
    assert st.terms.is_contiguous()


@pytest.mark.parametrize("wrapper", ["ica_steps", "ica_fused"])
def test_gn_wrappers_have_no_fallback(wrapper):
    """Only CPU tensors take the plain version: any other device launches the
    kernel or raises (here: 'meta' tensors), and wrong operands raise."""
    ref, mov, flow = _level(16, seed=5)
    st = ica.init_ica(t(ref), 16)
    fn = getattr(cuda_ica, wrapper)
    extra = (False,) if wrapper == "ica_fused" else ()
    meta = [x.to("meta") for x in (t(ref), st.gradx, st.grady, st.terms, t(mov), t(flow))]
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*meta, 16, 3, *extra)
    with pytest.raises(ValueError):
        fn(t(ref), st.gradx, st.grady, st.terms[:, :2], t(mov), t(flow), 16, 3, *extra)
    assert kernel_counts() == (0,) * 7
