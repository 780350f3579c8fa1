"""The port's fused pipeline form against the JAX package.

- ``merge_burst_slab`` and ``merge_burst_tiled`` (K6's plain version, then
  the refill per B-row slab or per (B, B) tile) against
  ``hmsr_tpu.models.merge_slab`` and ``merge_fused`` at the shapes of
  ``tests/test_merge_fused.py``: every pixel, starved ones included, to
  ``tools/verify_e2e_parity.py``'s bounds (mean|d| < 1e-4, max|d| < 1e-3),
  well-fed pixels to the per-stage bound max|d| <= 1e-4. At x3 the JAX merge
  runs op by op: compiled, XLA divides by 3 through the rounded reciprocal.
- K6's plain version equals ``merge_burst_plain`` into zeros at the padded
  geometry followed by the reference merge, bit for bit.
- ``run_pipeline`` in the fused (slab and tiled) form against the JAX
  pipeline in the same form on an occlusion burst whose moving disc leaves
  interior HR pixels without any compared frame (the fused image differs
  from the scan image there: the per-group refill), the scan form against
  the JAX package's vmapped form (its frames-batched analysis gives the
  scan image), and ``fused`` at a fractional scale is the scan form.
- ``tpu.pipeline: auto`` as the JAX package resolves it off the TPU: the
  fused form where the merge is tiled, the scan form otherwise; the port's
  default configuration through ``process_arrays`` against the JAX
  package's (whose ``auto`` runs the fused form on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import WB, curves, kernel_counts, n, small_config, t  # noqa: E402

from hmsr_tpu.configs import default_config, update_snr_config  # noqa: E402
from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_occlusion_burst  # noqa: E402
from hmsr_tpu.models import merge_fused as j_fused  # noqa: E402
from hmsr_tpu.models import merge_slab as j_slab  # noqa: E402
from hmsr_tpu.models.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from hmsr_tpu.models.process import process_arrays as j_process_arrays  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.models import merge_fused, merge_tiled  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402
from hmsr_tpu_torch.models.pipeline import make_pipeline, pipeline_form  # noqa: E402
from hmsr_tpu_torch.ops import cuda_merge  # noqa: E402
from hmsr_tpu_torch.ops.accumfix import STARVED_DEN, normalize_groups  # noqa: E402

CFA = np.array([[0, 1], [1, 2]])
#: (scale, variant, denoiser, frames, h, w) at Ts=16: the shapes of
#: tests/test_merge_fused.py; 72x88 x2 has an HR height (144) that is no
#: multiple of B = 32, so its last slab holds padded rows
MERGE_CASES = {
    "x2-bayer": (2, "bayer", False, 3, 64, 80),
    "x2-iso": (2, "iso", False, 3, 64, 80),
    "x2-grey": (2, "grey", False, 3, 64, 80),
    "x2-grey-iso": (2, "grey-iso", False, 3, 64, 80),
    "x2-denoiser": (2, "bayer", True, 3, 64, 80),
    "x1-bayer": (1, "bayer", False, 3, 64, 80),
    "x3-bayer": (3, "bayer", False, 2, 64, 80),
    "x2-bayer-72x88": (2, "bayer", False, 3, 72, 88),
}
VARIANTS = {"bayer": ("bayer", "steerable"), "iso": ("bayer", "iso"),
            "grey": ("grey", "steerable"), "grey-iso": ("grey", "iso")}


def merge_config(scale, variant, denoiser, ts=16):
    """``tests/test_merge_fused.py``'s configuration (SNR 20)."""
    c = default_config()
    c.scale = scale
    c.mode, c.merging.kernel = VARIANTS[variant]
    update_snr_config(c, 20)
    c.block_matching.tuning.tile_size = ts
    c.accumulated_robustness_denoiser.enabled = denoiser
    c.accumulated_robustness_denoiser.merge.enabled = denoiser
    return c


def merge_inputs(case, seed):
    """Seeded numpy inputs of ``case``: frames, flows of up to 5 px either
    way (negative ones reach past the image), robustness, covariances,
    the reference and its covariances, the accumulated robustness."""
    scale, variant, denoiser, F, h, w = MERGE_CASES[case]
    g = 2 if VARIANTS[variant][0] == "bayer" else 1
    rng = np.random.RandomState(seed)
    ny, nx = -(-h // 16), -(-w // 16)
    comp = rng.rand(F, h, w).astype(np.float32)
    ref = rng.rand(h, w).astype(np.float32)
    flows = ((rng.rand(F, ny, nx, 2) * 2 - 1) * 5).astype(np.float32)
    rmaps = rng.rand(F, h, w).astype(np.float32)
    gg = rng.rand(F, h // g, w // g, 2).astype(np.float32) + 0.3
    covs = np.stack([gg[..., 0], 0.2 * np.sqrt(gg[..., 0] * gg[..., 1]), gg[..., 1]],
                    axis=1).astype(np.float32)
    gg2 = rng.rand(h // g, w // g, 2).astype(np.float32) + 0.3
    ref_covs = np.stack([gg2[..., 0], 0.1 * gg2[..., 0], gg2[..., 1]]).astype(np.float32)
    acc_rob = (rng.rand(h, w) * 4).astype(np.float32) if denoiser else None
    return [comp, flows, covs, rmaps, ref, ref_covs], acc_rob


@pytest.mark.parametrize("impl", ["slab", "tiled"])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_burst_against_jax(case, impl):
    scale, variant, denoiser, *_ = MERGE_CASES[case]
    config = merge_config(scale, variant, denoiser)
    arrays, acc_rob = merge_inputs(case, seed=sorted(MERGE_CASES).index(case))
    j_fn = j_slab.merge_burst_slab if impl == "slab" else j_fused.merge_burst_tiled
    fn = merge_fused.merge_burst_slab if impl == "slab" else merge_fused.merge_burst_tiled
    with jax.disable_jit(scale == 3):
        want = np.asarray(j_fn(*map(jnp.asarray, arrays), CFA, config,
                               acc_rob=None if acc_rob is None else jnp.asarray(acc_rob)))
    got = n(fn(*map(t, arrays), CFA, config,
               acc_rob=None if acc_rob is None else t(acc_rob)))
    assert got.shape == want.shape == ((3 if variant in ("bayer", "iso") else 1),
                                       scale * arrays[4].shape[0],
                                       scale * arrays[4].shape[1])
    d = np.abs(got - want)
    assert np.isfinite(got).all()
    assert d.mean() < 1e-4 and d.max() < 1e-3
    # well-fed: the accumulated weight above the refill's threshold
    _, den = cuda_merge.merge_fused_plain(
        *map(t, arrays), CFA, 16, scale, variant.startswith("grey"),
        variant.endswith("iso"), **_denoiser_args(config, acc_rob))
    wellfed = n(den)[:, :got.shape[1], :got.shape[2]] > STARVED_DEN
    assert d[wellfed].max() <= 1e-4
    assert kernel_counts() == (0,) * 8


def _denoiser_args(config, acc_rob):
    if acc_rob is None:
        return {}
    m = config.accumulated_robustness_denoiser.merge
    return dict(acc_rob=t(acc_rob), rad_max=int(m.rad_max),
                max_multiplier=float(m.max_multiplier),
                max_frame_count=float(m.max_frame_count))


@pytest.mark.parametrize("case", ["x2-bayer-72x88", "x3-bayer", "x2-denoiser", "x2-grey-iso"])
def test_merge_fused_plain_is_frames_then_reference(case):
    """K6's plain version (and its wrapper on CPU tensors) equals zeroed
    accumulators at the padded geometry, the frames' plain merges with
    every padded row taking its share, then the reference merge; rows past
    the image receive frame samples through negative flows."""
    scale, variant, denoiser, F, h, w = MERGE_CASES[case]
    config = merge_config(scale, variant, denoiser)
    arrays, acc_rob = merge_inputs(case, seed=11)
    comp, flows, covs, rmaps, ref, ref_covs = map(t, arrays)
    grey, iso = merge_tiled.merge_variant(config)
    kw = _denoiser_args(config, acc_rob)
    got = cuda_merge.merge_fused_plain(comp, flows, covs, rmaps, ref, ref_covs, CFA, 16,
                                       scale, grey, iso, **kw)
    shape = cuda_merge.fused_accum_shape((h, w), 16, scale, grey)
    assert tuple(got[0].shape) == shape and shape[1] % (16 * scale) == 0
    num, den = torch.zeros(shape), torch.zeros(shape)
    cuda_merge.merge_burst_plain(comp, flows, covs, rmaps, num, den, CFA, 16, scale,
                                 grey, iso, all_rows=True)
    frames_den = den.clone()
    merge_tiled.merge_ref_tiled(ref, ref_covs, num, den, CFA, config,
                                acc_rob=kw.get("acc_rob"))
    assert torch.equal(got[0], num) and torch.equal(got[1], den)
    wrapped = cuda_merge.merge_fused_accumulate(comp, flows, covs, rmaps, ref, ref_covs,
                                                CFA, 16, scale, grey, iso, **kw)
    assert torch.equal(wrapped[0], num) and torch.equal(wrapped[1], den)
    if shape[1] > h * scale:
        assert float(frames_den[:, h * scale:].abs().max()) > 0
    assert kernel_counts() == (0,) * 8


@pytest.mark.parametrize("bad", ["rad_max", "comp_shape", "ref_covs_grid", "scale"])
def test_merge_fused_refuses(bad):
    """The K6 wrapper's checks: a denoiser radius under 1, frames of
    another size than the reference, covariance grids that differ, a
    fractional scale."""
    config = merge_config(2, "bayer", bad == "rad_max")
    arrays, acc_rob = merge_inputs("x2-denoiser", seed=3)
    comp, flows, covs, rmaps, ref, ref_covs = map(t, arrays)
    kw = _denoiser_args(config, acc_rob) if bad == "rad_max" else {}
    scale = 1.5 if bad == "scale" else 2
    if bad == "rad_max":
        kw["rad_max"] = 0
    elif bad == "comp_shape":
        comp = comp[:, :-2]
    elif bad == "ref_covs_grid":
        ref_covs = ref_covs[:, :-1]
    with pytest.raises(ValueError):
        cuda_merge.merge_fused_accumulate(comp, flows, covs, rmaps, ref, ref_covs, CFA,
                                          16, scale, **kw)


@pytest.mark.parametrize("tiles", [False, True])
def test_refill_groups_plain_and_checks(tiles):
    """K7's wrapper on CPU tensors is ``normalize_groups`` and the crop, bit
    for bit (a new tensor of the crop's shape); it refuses accumulators that
    are no whole groups of B, a crop larger than them and mismatched
    shapes."""
    rng = np.random.RandomState(7)
    den = rng.uniform(0, 2, (3, 96, 128)).astype(np.float32)
    den[rng.rand(*den.shape) < 0.2] = 0.0
    num = (den * rng.rand(*den.shape)).astype(np.float32)
    got = cuda_merge.refill_groups(t(num), t(den), 32, 90, 125, tiles)
    want = normalize_groups(t(num), t(den), 32, tiles)[:, :90, :125]
    assert tuple(got.shape) == (3, 90, 125) and torch.equal(got, want)
    for args in ((t(num)[:, :80], t(den)[:, :80], 32, 80, 125),
                 (t(num), t(den), 32, 97, 125),
                 (t(num), t(den)[:1], 32, 90, 125),
                 (t(num).double(), t(den), 32, 90, 125)):
        with pytest.raises(ValueError):
            cuda_merge.refill_groups(*args, tiles)
    assert kernel_counts() == (0,) * 8


# ---------------------------------------------------------------------------
# the pipeline's fused form, and the scan form against the JAX vmapped form
# ---------------------------------------------------------------------------

SIZE, N_FRAMES = 128, 4
#: the cases of test_pipeline_form_against_jax: the port's tpu.pipeline, the
#: JAX package's, fused_impl, and the x3 denoiser burst (the bench.py x3
#: cell: 96^2, 3 frames, seed 8) in place of the occlusion fixture's
FORMS = {"fused-slab": ("fused", "fused", "slab", False),
         "fused-tiled": ("fused", "fused", "tiled", False),
         "vmapped": ("scan", "vmapped", None, False),
         "vmapped-x3-denoiser": ("scan", "vmapped", None, True)}


@pytest.fixture(scope="module")
def occlusion():
    """A 128^2 4-frame occlusion burst (seed 21) and the port's scan image
    of it, with its debug dict."""
    ref, comps, _, _ = make_occlusion_burst(SIZE, SIZE, n_frames=N_FRAMES, seed=21,
                                            max_shift=2.0)
    config = small_config(SIZE)
    config.debug = True
    std, diff = curves()
    scan = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    return ref, comps, scan


@pytest.mark.parametrize("form", list(FORMS))
def test_pipeline_form_against_jax(occlusion, form):
    """The port's form against the JAX pipeline in the form of the case:
    flows within 1e-2, the image within the e2e bounds on every pixel (on
    the interior at x3, where the compiled JAX merge divides by 3 through
    the rounded reciprocal, about 1e-5), the accumulated robustness within
    the per-frame robustness tolerance times the frames. The fused image
    differs from the port's scan image by more than 1e-3 at some interior
    pixel (robustness cuts the moving disc's HR pixels off from every
    compared frame, and only the fused form refills them). The JAX
    package's vmapped form stays a reference of the port's scan form, at x2
    and at x3 with the accumulated-robustness denoiser."""
    mode, j_mode, impl, x3 = FORMS[form]
    if x3:
        ref, comps, _, _ = make_occlusion_burst(96, 96, n_frames=3, seed=8, max_shift=2.0)
        config = small_config(96)
        config.scale = 3
        config.accumulated_robustness_denoiser.enabled = True
    else:
        ref, comps, (img_s, _) = occlusion
        config = small_config(SIZE)
    config.debug = True
    if impl:
        config.tpu.fused_impl = impl
    std, diff = curves()
    config.tpu.pipeline = j_mode
    img_j, dbg_j = j_make_pipeline(config, DEFAULT_CFA, WB)(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))
    config.tpu.pipeline = mode
    img_t, dbg_t = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    assert dbg_t.keys() == dbg_j.keys()
    assert np.abs(n(dbg_t["flow"]) - np.asarray(dbg_j["flow"])).max() < 1e-2
    d = np.abs(n(img_t) - np.asarray(img_j))
    if x3:
        d = d[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3
    assert np.abs(n(dbg_t["accumulated_robustness"])
                  - np.asarray(dbg_j["accumulated_robustness"])).max() \
        < 1e-3 * (len(comps) + 1)           # the frames, the reference's included
    if mode == "fused":
        assert np.abs(n(img_t) - n(img_s))[32:-32, 32:-32].max() > 1e-3
    assert kernel_counts() == (0,) * 8


@pytest.mark.parametrize("impl", ["slab", "tiled"])
def test_fused_fractional_scale_is_scan(impl):
    """At a fractional scale the fused form runs the scan form (the JAX
    package's ``fused = pipe_mode == "fused" and _use_tiled(config)``)."""
    ref, comps, _, _ = make_occlusion_burst(SIZE, SIZE, n_frames=3, seed=5, max_shift=2.0)
    config = small_config(SIZE)
    config.scale = 1.5
    std, diff = curves()
    img_s, _ = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    config.tpu.pipeline = "fused"
    config.tpu.fused_impl = impl
    img_f, _ = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    assert img_f.shape == (192, 192, 3)
    assert torch.equal(img_f, img_s)


# ---------------------------------------------------------------------------
# tpu.pipeline: auto
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,impl,form", [
    (2, None, "fused"), (3, None, "fused"), (1, None, "fused"), (1.5, None, "scan"),
    (2, "gather", "scan"), (2, "tiled", "fused"), (2.5, "gather", "scan")])
def test_auto_form(scale, impl, form):
    """``auto`` (the default) is the JAX package's choice off the TPU,
    ``fused`` where the merge is tiled (``_use_tiled``: an integer scale
    and no ``gather``) and ``scan`` otherwise; the default configuration
    sets neither key."""
    c = configs.default_config()
    assert "tpu" not in c
    c.scale = scale
    if impl:
        c["tpu"] = {"merge_impl": impl}
    assert pipeline_form(c) == form


def test_default_process_arrays_against_jax_auto():
    """The port's default configuration through ``process_arrays`` (its
    ``auto``: the fused form) against the JAX package's default through its
    ``process_arrays`` on the CPU (also the fused form): the e2e criteria on
    the interior and the accumulated robustness within the per-frame
    tolerance times the frames."""
    from test_torch_process import _tune
    from hmsr_tpu.configs import default_config as j_default_config
    ref, comps, _, _ = make_occlusion_burst(SIZE, SIZE, n_frames=N_FRAMES, seed=21,
                                            max_shift=2.0)
    jc = _tune(j_default_config(), False)
    pc = _tune(configs.default_config(), False)
    assert pipeline_form(pc) == "fused"
    img_j, dbg_j = j_process_arrays(ref, comps, jc, iso=100)
    img_t, dbg_t = P.process_arrays(ref, comps, pc, iso=100, device="cpu")
    assert tuple(img_t.shape) == (2 * SIZE, 2 * SIZE, 3)
    d = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3, (d.mean(), d.max())
    d_acc = np.abs(n(dbg_t["accumulated_robustness"])
                   - np.asarray(dbg_j["accumulated_robustness"]))
    assert d_acc.max() < 1e-3 * N_FRAMES
    assert kernel_counts() == (0,) * 8


def test_probe_fused_kernel_needs_the_card(monkeypatch):
    """The K6 variant probe refuses to run without a card (no CPU
    fallback for a device measurement)."""
    from hmsr_tpu_torch import probe_fused_kernel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        probe_fused_kernel.main([])
