"""The port's kernel estimation and merges (K5, K5') against the JAX package.

``estimate_kernels`` and the merges' num/den within 1e-5 relative; K5''s
plain version against the JAX burst-fused Pallas merge within 1e-6, and
against K5's plain version exactly. The merges in every variant: Bayer or
grey mode, steerable or isotropic kernel, and the reference merge with the
accumulated-robustness denoiser.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
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


#: the merge variants (mode, merging.kernel) the Pallas kernel carries
VARIANTS = {"bayer": ("bayer", "steerable"), "grey": ("grey", "steerable"),
            "iso": ("bayer", "iso"), "grey-iso": ("grey", "iso")}
BAYER_TS_SCALES = [(16, 2), (32, 2), (16, 3), (8, 1), (64, 2), (32, 3), (16, 1), (32, 1),
                   (64, 1), (64, 3)]
GRID = [(ts, s) for ts in (16, 32, 64) for s in (1, 2, 3)]


def _variant_cases(grid=GRID):
    """``(variant, *args)`` cases: Bayer-steerable under its bare ids (as
    before the grey and iso variants were ported), the others at ``grid``."""
    cases = [pytest.param("bayer", *a, id="-".join(map(str, a))) for a in BAYER_TS_SCALES]
    return cases + [pytest.param(v, *a, id="-".join(map(str, (v, *a))))
                    for v in ("grey", "iso", "grey-iso") for a in grid]


def _variant_config(variant, ts=16, scale=2):
    config = small_config(128, ts)
    config.scale = scale
    config.mode, config.merging.kernel = VARIANTS[variant]
    return config


@pytest.mark.parametrize("variant,ts,scale", _variant_cases())
def test_merge_tiled(frames, variant, ts, scale):
    """Flows with negative fractions (covariance extrapolation at index -1),
    exact halves, and tiles pushed out of the frame (ok_tile); grey mode's
    covariances on the raw grid.

    Grey mode's steerable kernel at x3 holds against the JAX merge evaluated
    op by op (``jax.disable_jit``): compiled, XLA turns ``(R + 0.5) / 3``
    into a multiplication by the rounded reciprocal, an ulp off for a third
    of the rows, which grey mode's anisotropic weights amplify to 1.1e-5
    relative (Bayer's to 8.7e-6, iso's to 2.5e-6); op by op, JAX divides as
    the port does (within 1.2e-7)."""
    ref, comp = frames
    config = _variant_config(variant, ts, scale)
    n_ch = 3 if config.mode == "bayer" else 1
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(comp), config))
    rng = np.random.RandomState(ts + scale)
    flow = rng.uniform(-2.5, 2.5, (-(-H // ts), -(-W // ts), 2)).astype(np.float32)
    flow[0, 0] = (-0.75, -0.25)
    flow[0, 1] = (0.5, -1.5)
    flow[-1, -1] = (-40.0, 35.0)
    r = rng.rand(H, W).astype(np.float32)
    num = rng.rand(n_ch, H * scale, W * scale).astype(np.float32)
    den = rng.rand(n_ch, H * scale, W * scale).astype(np.float32)
    with jax.disable_jit(scale == 3 and variant == "grey"):
        want = j_merge.merge_tiled(jnp.asarray(comp), jnp.asarray(flow),
                                   jnp.asarray(covs), jnp.asarray(r), jnp.asarray(num),
                                   jnp.asarray(den), DEFAULT_CFA, config)
    num_t, den_t = t(num), t(den)
    got = merge_tiled.merge_tiled(t(comp), t(flow), t(covs), t(r), num_t, den_t,
                                  DEFAULT_CFA, config)
    assert got[0] is num_t and got[1] is den_t          # accumulated in place
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5


REF_CASES = [pytest.param("bayer", s, False, id=str(s)) for s in (1, 2, 3)] + [
    pytest.param(v, s, dn, id=f"{v}-{s}" + ("-denoiser" if dn else ""))
    for v, s, dn in (("grey", 1, False), ("grey", 2, False), ("grey", 3, False),
                     ("iso", 2, False), ("iso", 3, False), ("grey-iso", 2, False),
                     ("grey-iso", 3, False), ("bayer", 2, True), ("bayer", 3, True),
                     ("grey", 2, True), ("grey-iso", 3, True))]


@pytest.mark.parametrize("variant,scale,denoiser", REF_CASES)
def test_merge_ref_tiled(frames, variant, scale, denoiser):
    """The reference merge in every variant; with the accumulated-robustness
    denoiser, an ``acc_rob`` in [0, 4] that crosses ``max_frame_count`` (2):
    5x5 taps and z / 8 where it is at most 2, num/den overwritten where it is
    below."""
    ref, _ = frames
    config = _variant_config(variant, scale=scale)
    config.accumulated_robustness_denoiser.enabled = denoiser
    n_ch = 3 if config.mode == "bayer" else 1
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(ref), config))
    rng = np.random.RandomState(scale)
    num = rng.rand(n_ch, H * scale, W * scale).astype(np.float32)
    den = rng.rand(n_ch, H * scale, W * scale).astype(np.float32)
    acc = rng.uniform(0, 4, (H, W)).astype(np.float32) if denoiser else None
    if denoiser:
        acc[::7] = 2.0                                  # exactly max_frame_count
    want = j_merge.merge_ref_tiled(jnp.asarray(ref), jnp.asarray(covs), jnp.asarray(num),
                                   jnp.asarray(den), DEFAULT_CFA, config,
                                   acc_rob=None if acc is None else jnp.asarray(acc))
    got = merge_tiled.merge_ref_tiled(t(ref), t(covs), t(num), t(den), DEFAULT_CFA, config,
                                      acc_rob=None if acc is None else t(acc),
                                      band_rows=40)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5
    if denoiser:                # the overwrite and the wide taps took effect
        plain = merge_tiled.merge_ref_tiled(t(ref), t(covs), t(num), t(den), DEFAULT_CFA,
                                            config, band_rows=40)
        assert not torch.equal(got[0], plain[0])


def test_merge_ref_denoiser_needs_acc_rob(frames):
    """Without ``acc_rob`` the enabled denoiser leaves the reference merge
    as it is, and ``acc_rob`` without the denoiser enabled is not read (the
    JAX package's rule)."""
    ref, _ = frames
    config = _variant_config("bayer")
    covs = t(j_kernels.estimate_kernels(jnp.asarray(ref), config))
    z = torch.zeros(3, 2 * H, 2 * W)
    plain = merge_tiled.merge_ref_tiled(t(ref), covs, z.clone(), z.clone(), DEFAULT_CFA,
                                        config)
    unread = merge_tiled.merge_ref_tiled(t(ref), covs, z.clone(), z.clone(), DEFAULT_CFA,
                                         config, acc_rob=torch.zeros(H, W))
    config.accumulated_robustness_denoiser.enabled = True
    no_acc = merge_tiled.merge_ref_tiled(t(ref), covs, z.clone(), z.clone(), DEFAULT_CFA,
                                         config)
    for got in (unread, no_acc):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def _burst_inputs(seed, F, h, w, ts, grey=False):
    """``tests/test_pallas_merge.py:_burst_inputs``: covariances on the grey
    grid (h/2, w/2), or on the raw grid for ``grey`` mode."""
    rng = np.random.RandomState(seed)
    ny, nx = -(-h // ts), -(-w // ts)
    comp = rng.rand(F, h, w).astype(np.float32)
    flow = (rng.rand(F, ny, nx, 2) * 2 - 1).astype(np.float32) * 5.0
    r = rng.rand(F, h, w).astype(np.float32)
    g = 1 if grey else 2
    gg = rng.rand(F, h // g, w // g, 2).astype(np.float32) + 0.3
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
    _check_burst_against_pallas("bayer")


@pytest.mark.parametrize("variant", ["grey", "iso"])
def test_merge_burst_variants_against_jax_burst_pallas(variant):
    """As :func:`test_merge_burst_against_jax_burst_pallas`, in grey mode
    (covariances on the raw grid, one plane) and with the isotropic
    kernel."""
    _check_burst_against_pallas(variant)


def _check_burst_against_pallas(variant):
    from hmsr_tpu.configs import default_config, update_snr_config
    from hmsr_tpu.ops.pallas_merge import merge_burst_pallas, padded_accum_shape
    seed, F, h, w, ts, s = 23, 4, 32, 128, 16, 2
    config = default_config()
    config.scale = s
    update_snr_config(config, 20)
    config.block_matching.tuning.tile_size = ts
    config.mode, config.merging.kernel = VARIANTS[variant]
    grey, iso = config.mode == "grey", config.merging.kernel == "iso"
    comp, flow, cov, r = _burst_inputs(seed, F, h, w, ts, grey)
    rng = np.random.RandomState(seed)
    pad = padded_accum_shape(config, (h, w))
    num0 = rng.rand(*pad).astype(np.float32)
    den0 = rng.rand(*pad).astype(np.float32)
    want = merge_burst_pallas(jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(cov),
                              jnp.asarray(r), jnp.asarray(num0), jnp.asarray(den0),
                              DEFAULT_CFA, config, interpret=True)
    num, den = t(num0[:, :s * h, :s * w]), t(den0[:, :s * h, :s * w])
    got = cuda_merge.merge_burst_accumulate(t(comp), t(flow), t(cov), t(r), num, den,
                                            DEFAULT_CFA, ts, s, grey, iso)
    assert got[0] is num and got[1] is den          # accumulated in place
    for g, wnt in zip(got, want):
        assert rel_err(g, np.asarray(wnt)[:, :s * h, :s * w]) <= 1e-6
    assert kernel_counts() == (0,) * 8


BURST_CASES = [(3, 16, 2), (2, 32, 2), (4, 16, 3), (2, 64, 2), (2, 16, 1), (2, 32, 1),
               (2, 64, 1), (2, 32, 3), (2, 64, 3)]


@pytest.mark.parametrize("variant,F,ts,scale", [
    pytest.param("bayer", *c, id="-".join(map(str, c))) for c in BURST_CASES] + [
    pytest.param(v, *c, id="-".join(map(str, (v, *c))))
    for v in ("grey", "iso", "grey-iso") for c in BURST_CASES[:5]])
def test_merge_burst_equals_sequential_frames(variant, F, ts, scale):
    """K5''s plain version is F plain K5 merges in frame order, bit for
    bit (the property K5' holds against K5 on the card), at every (Ts,
    scale) the kernels are checked at on the card, in every variant."""
    h, w = 64, 96
    grey, iso = VARIANTS[variant][0] == "grey", VARIANTS[variant][1] == "iso"
    comp, flow, cov, r = _burst_inputs(F + ts, F, h, w, ts, grey)
    flow[0, 0, 0] = (-40.0, 35.0)                   # a clipped tile (ok_tile)
    rng = np.random.RandomState(ts)
    n_ch = 1 if grey else 3
    num0 = rng.rand(n_ch, scale * h, scale * w).astype(np.float32)
    den0 = rng.rand(n_ch, scale * h, scale * w).astype(np.float32)
    n_b, d_b = t(num0), t(den0)
    cuda_merge.merge_burst_plain(t(comp), t(flow), t(cov), t(r), n_b, d_b,
                                 DEFAULT_CFA, ts, scale, grey, iso)
    n_s, d_s = t(num0), t(den0)
    for f in range(F):
        cuda_merge.merge_plain(t(comp[f]), t(flow[f]), t(cov[f]), t(r[f]), n_s, d_s,
                               DEFAULT_CFA, ts, scale, grey, iso)
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
    assert kernel_counts() == (0,) * 8


def test_cpu_wrapper_launches_no_kernel(frames):
    _, comp = frames
    num, den = torch.zeros(3, 2 * H, 2 * W), torch.zeros(3, 2 * H, 2 * W)
    covs = torch.eye(2)[[0, 0, 1], [0, 1, 1]][:, None, None].expand(3, H // 2, W // 2)
    cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                torch.ones(H, W), num, den, DEFAULT_CFA, 16, 2)
    assert kernel_counts() == (0,) * 8
    assert float(den.sum()) > 0
    with pytest.raises(ValueError):      # accumulators of the wrong size
        cuda_merge.merge_accumulate(t(comp), torch.zeros(4, 6, 2), covs.contiguous(),
                                    torch.ones(H, W), num[:, :-1], den, DEFAULT_CFA, 16, 2)


def test_merge_wrapper_plane_count():
    """The accumulators' plane count follows the mode: 3 in Bayer mode, 1 in
    grey mode; either raises with the other's."""
    comp, flow, cov, r = _burst_inputs(2, 1, 64, 96, 16, grey=True)
    args = (t(comp[0]), t(flow[0]), t(cov[0]), t(r[0]))
    one, three = torch.zeros(1, 128, 192), torch.zeros(3, 128, 192)
    cuda_merge.merge_accumulate(*args, one, one.clone(), None, 16, 2, grey=True)
    for acc, grey in ((three, True), (one, False)):
        with pytest.raises(ValueError):
            cuda_merge.merge_accumulate(*args, acc, acc.clone(), DEFAULT_CFA, 16, 2,
                                        grey=grey)
    assert kernel_counts() == (0,) * 8


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_scale_divisor_divides(scale):
    """The plain merges divide HR coordinates by the scale as the JAX
    package and the kernels do: one rounding (at s=3 a multiplication by
    the rounded reciprocal differs for a third of the values)."""
    x = torch.arange(0, 30000, dtype=torch.float32) + 0.5
    got = (x / cuda_merge.scale_divisor(scale, x.device)).numpy()
    np.testing.assert_array_equal(got, x.numpy() / np.float32(scale))
    assert got.dtype == np.float32
