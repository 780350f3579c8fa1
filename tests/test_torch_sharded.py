"""The port's multi-device path (``hmsr_tpu_torch.parallel``) and its banded
merge stages against the JAX package, on the CPU.

The banded stages (K5's plain version, the reference merge and the gather
merge with ``row_offset``) equal their whole-image runs bit for bit, and
agree with the JAX package's banded merges within 1e-4 relative. The
sharded pipeline runs in ranks that :func:`spawn_ranks` starts (gloo,
``init_method`` a file under ``tmp_path``), held against the port's
single-device scan pipeline (the dry run's ``atol=5e-4, rtol=1e-3``, and
interior mean|d| < 1e-4) and against the JAX package's scan pipeline and
its sharded pipeline under ``tools/verify_e2e_parity.py``'s bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from torch_port_helpers import ALPHA, BETA, curves, kernel_counts, rel_err, small_config, t  # noqa: E402

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models import kernels as j_kernels  # noqa: E402
from hmsr_tpu.models import merge as j_gather  # noqa: E402
from hmsr_tpu.models import merge_tiled as j_merge  # noqa: E402
from hmsr_tpu.models.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from hmsr_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from hmsr_tpu.parallel import make_sharded_pipeline as j_make_sharded  # noqa: E402
from hmsr_tpu.parallel import pad_frames as j_pad_frames  # noqa: E402
from hmsr_tpu_torch.models import merge as gather  # noqa: E402
from hmsr_tpu_torch.models import merge_tiled  # noqa: E402
from hmsr_tpu_torch.models.pipeline import make_pipeline  # noqa: E402
from hmsr_tpu_torch.ops import cuda_merge  # noqa: E402
from hmsr_tpu_torch.parallel import make_mesh, pad_frames, sharded, spawn_ranks  # noqa: E402

H, W = 72, 96                   # 72 rows: the last tile row is partial at Ts=16
VARIANTS = {"bayer": ("bayer", "steerable"), "grey": ("grey", "steerable"),
            "iso": ("bayer", "iso"), "grey-iso": ("grey", "iso")}
MESHES = [(2, 2), (4, 1), (1, 4)]
PIPE_SIZE, PIPE_FRAMES = 64, 6


@pytest.fixture(scope="module")
def frames():
    ref, comps, _, _ = make_synthetic_burst(H, W, n_frames=2, seed=4)
    return ref, comps[0]


def _config(variant, scale, ts=16):
    c = small_config(128, ts)
    c.scale = scale
    c.mode, c.merging.kernel = VARIANTS[variant]
    return c


def _bands(config, n_bands):
    """``(rows, [row_offset, ...])`` of the sharded pipeline's bands."""
    rows = sharded.band_geometry(config, (H, W), n_bands)
    return rows, [sp * rows for sp in range(n_bands)]


def _merge_inputs(comp, config, seed):
    n_ch = 3 if config.mode == "bayer" else 1
    ts = config.block_matching.tuning.tile_size
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(comp), config))
    rng = np.random.RandomState(seed)
    flow = rng.uniform(-2.5, 2.5, (-(-H // ts), -(-W // ts), 2)).astype(np.float32)
    flow[0, 0] = (-0.75, -0.25)
    flow[-1, -1] = (-40.0, 35.0)                    # a tile pushed out of the frame
    return n_ch, covs, flow, rng.rand(H, W).astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_banded_merge_plain(frames, variant, scale):
    """K5's plain version into 2, 3 and 4 bands (whole tile rows; at x1 and
    x3 with 3 bands, and at 4, the last one starts past the image and takes
    nothing) equals the whole accumulator bit for bit; at x2 the 2 bands
    agree with JAX's ``merge_tiled(row_offset=)`` within 1e-4 relative."""
    _, comp = frames
    config = _config(variant, scale)
    grey, iso = merge_tiled.merge_variant(config)
    n_ch, covs, flow, r = _merge_inputs(comp, config, 10 * scale)
    out_h, out_w = H * scale, W * scale
    args = (t(comp), t(flow), t(covs), t(r))
    want_n, want_d = torch.zeros(n_ch, out_h, out_w), torch.zeros(n_ch, out_h, out_w)
    cuda_merge.merge_plain(*args, want_n, want_d, DEFAULT_CFA, 16, scale, grey, iso)
    for n_bands in (2, 3, 4):
        rows, offsets = _bands(config, n_bands)
        got_n, got_d = [], []
        for off in offsets:
            num, den = torch.zeros(n_ch, rows, out_w), torch.zeros(n_ch, rows, out_w)
            merge_tiled.merge_tiled(*args, num, den, DEFAULT_CFA, config, row_offset=off)
            got_n.append(num)
            got_d.append(den)
            if n_bands == 2 and scale == 2:
                j_n, j_d = j_merge.merge_tiled(
                    jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(covs),
                    jnp.asarray(r), jnp.zeros((n_ch, rows, out_w)),
                    jnp.zeros((n_ch, rows, out_w)), DEFAULT_CFA, config,
                    row_offset=off)
                keep = min(rows, out_h - off)
                assert rel_err(num[:, :keep], j_n[:, :keep]) <= 1e-4
                assert rel_err(den[:, :keep], j_d[:, :keep]) <= 1e-4
        got_n, got_d = torch.cat(got_n, 1), torch.cat(got_d, 1)
        assert torch.equal(got_n[:, :out_h], want_n)
        assert torch.equal(got_d[:, :out_h], want_d)
        assert not got_n[:, out_h:].any() and not got_d[:, out_h:].any()
    assert kernel_counts() == (0,) * 7


def test_banded_merge_checks(frames):
    """A band must start on a tile row; K5' takes no band."""
    _, comp = frames
    config = _config("bayer", 2)
    n_ch, covs, flow, r = _merge_inputs(comp, config, 1)
    args = (t(comp), t(flow), t(covs), t(r))
    num = torch.zeros(3, 64, 2 * W)
    with pytest.raises(ValueError):
        cuda_merge.merge_accumulate(*args, num, num.clone(), DEFAULT_CFA, 16, 2,
                                    row_offset=16)
    with pytest.raises(ValueError):
        cuda_merge.merge_burst_accumulate(*(a[None] for a in args), num, num.clone(),
                                          DEFAULT_CFA, 16, 2)


REF_CASES = [("bayer", 2, False), ("bayer", 2, True), ("grey-iso", 3, True),
             ("iso", 1, False)]


@pytest.mark.parametrize("variant,scale,denoiser", REF_CASES)
def test_banded_merge_ref(frames, variant, scale, denoiser):
    """The reference merge by bands equals it whole (rows past the image
    cropped) bit for bit, and each band is within 1e-4 relative of JAX's
    ``merge_ref(row_offset=)`` on its rows in the image, with and without
    the accumulated-robustness denoiser."""
    ref, _ = frames
    config = _config(variant, scale)
    config.accumulated_robustness_denoiser.enabled = denoiser
    n_ch = 3 if config.mode == "bayer" else 1
    covs = np.asarray(j_kernels.estimate_kernels(jnp.asarray(ref), config))
    rng = np.random.RandomState(scale)
    acc = rng.uniform(0, 4, (H, W)).astype(np.float32) if denoiser else None
    acc_t = None if acc is None else t(acc)
    out_h, out_w = H * scale, W * scale
    want = [torch.zeros(n_ch, out_h, out_w) for _ in range(2)]
    merge_tiled.merge_ref_tiled(t(ref), t(covs), *want, DEFAULT_CFA, config,
                                acc_rob=acc_t, band_rows=40)
    rows, offsets = _bands(config, 3)
    got = [[], []]
    for off in offsets:
        band = [torch.zeros(n_ch, rows, out_w) for _ in range(2)]
        merge_tiled.merge_ref_tiled(t(ref), t(covs), *band, DEFAULT_CFA, config,
                                    acc_rob=acc_t, band_rows=40, row_offset=off)
        if off < out_h:
            j_band = j_gather.merge_ref(jnp.asarray(ref), jnp.asarray(covs),
                                        jnp.zeros((n_ch, rows, out_w)),
                                        jnp.zeros((n_ch, rows, out_w)), DEFAULT_CFA,
                                        config, acc_rob=None if acc is None
                                        else jnp.asarray(acc), row_offset=off)
            keep = min(rows, out_h - off)
            for g, j in zip(band, j_band):
                assert rel_err(g[:, :keep], j[:, :keep]) <= 1e-4
        for k in range(2):
            got[k].append(band[k])
    for k in range(2):
        assert torch.equal(torch.cat(got[k], 1)[:, :out_h], want[k])


@pytest.mark.parametrize("n_bands", [2, 3, 4])
def test_banded_gather_merge(frames, n_bands):
    """The gather merge at x1.5 in ``out_h / n`` row bands equals it whole
    bit for bit, and each band is within 1e-4 relative of JAX's
    ``merge(row_offset=)``; a band count that does not divide the rows
    raises."""
    _, comp = frames
    config = _config("bayer", 1.5)
    n_ch, covs, flow, r = _merge_inputs(comp, config, 7)
    out_h, out_w = 108, 144
    args = (t(comp), t(flow), t(covs), t(r))
    want = [torch.zeros(n_ch, out_h, out_w) for _ in range(2)]
    gather.merge(*args, *want, DEFAULT_CFA, config, band_rows=20)
    rows = sharded.band_geometry(config, (H, W), n_bands)
    got = [[], []]
    for sp in range(n_bands):
        band = [torch.zeros(n_ch, rows, out_w) for _ in range(2)]
        gather.merge(*args, *band, DEFAULT_CFA, config, band_rows=20, row_offset=sp * rows)
        j_band = j_gather.merge(jnp.asarray(comp), jnp.asarray(flow), jnp.asarray(covs),
                                jnp.asarray(r), jnp.zeros((n_ch, rows, out_w)),
                                jnp.zeros((n_ch, rows, out_w)), DEFAULT_CFA, config,
                                row_offset=sp * rows)
        for g, j in zip(band, j_band):
            assert rel_err(g, j) <= 1e-4
        for k in range(2):
            got[k].append(band[k])
    for k in range(2):
        assert torch.equal(torch.cat(got[k], 1), want[k])
    with pytest.raises(ValueError):
        sharded.band_geometry(config, (H, W), 5)


@pytest.mark.parametrize("n,shards", [(5, 4), (6, 3), (3, 1)])
def test_pad_frames(n, shards):
    comps = np.random.RandomState(n).rand(n, 8, 8).astype(np.float32)
    frames, weights = pad_frames(t(comps), shards)
    j_frames, j_weights = j_pad_frames(comps, shards)
    assert np.array_equal(frames.numpy(), j_frames)
    assert np.array_equal(weights.numpy(), j_weights)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh(2, 2)


# ---------------------------------------------------------------------------
# the sharded pipeline in four ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def burst():
    ref, comps, _, _ = make_synthetic_burst(PIPE_SIZE, PIPE_SIZE, n_frames=PIPE_FRAMES,
                                            seed=9)
    return ref, comps


@pytest.fixture(scope="module")
def single(burst):
    """The port's single-device scan pipeline on the CPU."""
    ref, comps = burst
    config = ranks.pipeline_config(PIPE_SIZE, PIPE_SIZE)
    return make_pipeline(config, DEFAULT_CFA, ranks.WB, "cpu")(t(ref), t(comps),
                                                               *curves())


@pytest.fixture(scope="module")
def sharded_runs(burst, tmp_path_factory):
    """Rank 0's results of every mesh of :data:`MESHES`, and whether every
    rank returned the same image: one spawn of four ranks."""
    ref, comps = burst
    res = spawn_ranks(ranks.sharded_meshes, 4, args=(MESHES, t(ref), t(comps)),
                      tmp_dir=str(tmp_path_factory.mktemp("ranks")), threads=1)
    same = {m: all(torch.equal(torch.nan_to_num(r[m][0]), torch.nan_to_num(res[0][m][0]))
                   for r in res) for m in MESHES}
    return res[0], same


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_against_single_device(sharded_runs, single, mesh):
    """Every rank returns the same image; it is within the dry run's bound
    of the single-device pipeline (and interior mean|d| < 1e-4), with the
    accumulated robustness within 1e-5 and the debug flows and robustness
    maps (the padded frames dropped) within 1e-5."""
    runs, same = sharded_runs
    image, acc_r, flows, rmaps, comm = runs[mesh]
    want, debug = single
    assert same[mesh]
    assert tuple(image.shape) == tuple(want.shape)
    got, ref_img = torch.nan_to_num(image).numpy(), torch.nan_to_num(want).numpy()
    np.testing.assert_allclose(got, ref_img, atol=5e-4, rtol=1e-3)
    assert np.abs(got - ref_img)[8:-8, 8:-8].mean() < 1e-4
    n = PIPE_FRAMES - 1
    assert flows.shape[0] == -(-n // mesh[0]) * mesh[0]
    assert float((acc_r - debug["accumulated_robustness"]).abs().max()) <= 1e-5
    assert float((flows[:n] - debug["flow"]).abs().max()) <= 1e-5
    assert float((rmaps[:n] - debug["robustness"]).abs().max()) <= 1e-5
    assert not rmaps[n:].any()                      # padding frames weigh nothing
    assert comm["all_reduce"] == (2 if mesh[0] > 1 else 0)
    assert comm["broadcast"] == (6 * mesh[1] if mesh[1] > 1 else 0) \
        + (2 * mesh[0] if mesh[0] > 1 else 0)


@pytest.fixture(scope="module")
def jax_scan(burst):
    ref, comps = burst
    config = small_config(PIPE_SIZE)
    config.debug = True
    config.robustness.save_mask = True
    std, diff = curves()
    return j_make_pipeline(config, DEFAULT_CFA, ranks.WB)(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))


def _e2e_parity(image, flows, want_image, want_flows):
    """``tools/verify_e2e_parity.py``'s bounds: flow max|d| < 1e-2, image
    mean|d| < 1e-4 and max|d| < 1e-3 on the interior."""
    d_img = np.abs(np.nan_to_num(image) - np.nan_to_num(want_image))[8:-8, 8:-8]
    d_flow = np.abs(np.asarray(flows) - np.asarray(want_flows))
    assert d_flow.max() < 1e-2 and d_img.mean() < 1e-4 and d_img.max() < 1e-3


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_against_jax_scan(sharded_runs, jax_scan, mesh):
    """The sharded pipeline against JAX's single-device scan pipeline under
    the e2e bounds; the accumulated robustness and the robustness maps
    within 1e-3 per frame."""
    image, acc_r, flows, rmaps, _ = sharded_runs[0][mesh]
    want, debug = jax_scan
    n = PIPE_FRAMES - 1
    _e2e_parity(image.numpy(), flows[:n].numpy(), np.asarray(want), debug["flow"])
    assert np.abs(acc_r.numpy() - np.asarray(debug["accumulated_robustness"])).max() \
        < 1e-3 * n
    assert np.abs(rmaps[:n].numpy() - np.asarray(debug["robustness"])).max() < 1e-3


def test_sharded_against_jax_sharded(sharded_runs, burst):
    """The port's (2, 2) mesh against JAX's ``make_sharded_pipeline`` on a
    (2, 2) mesh of the virtual CPU devices, under the e2e bounds."""
    ref, comps = burst
    config = small_config(PIPE_SIZE)
    config.debug = True
    config.robustness.save_mask = True
    std, diff = curves()
    frames, weights = j_pad_frames(comps, 2)
    pipe = j_make_sharded(config, DEFAULT_CFA, ranks.WB, j_make_mesh(2, 2))
    want, j_acc, j_flows, _ = pipe(jnp.asarray(ref), jnp.asarray(frames),
                                   jnp.asarray(weights), jnp.asarray(std),
                                   jnp.asarray(diff))
    image, acc_r, flows, _, _ = sharded_runs[0][(2, 2)]
    _e2e_parity(image.numpy(), flows.numpy(), np.asarray(want), j_flows)
    assert np.abs(acc_r.numpy() - np.asarray(j_acc)).max() < 1e-3 * (PIPE_FRAMES - 1)


def test_process_arrays_mesh(burst, tmp_path, monkeypatch):
    """``process_arrays`` with ``tpu.mesh = [2, 1]`` in two ranks: the noise
    curves drawn on rank 0 reach rank 1 (its own draw would differ), and
    both ranks return the single-device image (the dry run's bound) and
    accumulated robustness (1e-5)."""
    from hmsr_tpu_torch.configs import default_config
    from hmsr_tpu_torch.models import process as P
    ref, comps = burst
    config = default_config()
    config.scale = 2
    config.verbose = 0
    config.noise_model.update(alpha=ALPHA, beta=BETA)
    config.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],
                                        search_radii=[1, 4], metrics=["L1", "L2"])
    config.postprocessing.enabled = False
    config.robustness.save_mask = True
    config["tpu"] = {"mesh": [2, 1]}
    res = spawn_ranks(ranks.process_mesh, 2, args=(t(ref), t(comps), config),
                      tmp_dir=str(tmp_path), threads=1)
    monkeypatch.setattr(P, "run_fast_MC", ranks.affine_mc(0))
    config["tpu"] = {}
    want, debug = P.process_arrays(ref, comps, config, cfa=ranks.CFA, device="cpu")
    for image, dbg in res:
        np.testing.assert_allclose(torch.nan_to_num(image).numpy(),
                                   torch.nan_to_num(want).numpy(), atol=5e-4, rtol=1e-3)
        assert float((dbg["accumulated_robustness"]
                      - debug["accumulated_robustness"]).abs().max()) <= 1e-5
    assert torch.equal(res[0][0], res[1][0])


def test_dryrun_multichip(capsys):
    """The port's dry run in four ranks on the CPU: both meshes OK."""
    from hmsr_tpu_torch.graft_entry import dryrun_multichip
    lines = dryrun_multichip(4, device="cpu")
    assert len(lines) == 2 and all(ln.startswith("dryrun_multichip OK") for ln in lines)
    assert "mesh=(2 frames x 2 space)" in capsys.readouterr().out
