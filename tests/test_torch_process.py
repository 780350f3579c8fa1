"""The port's public API (``process_arrays``, ``process_burst``, ``process``)
and the modules it runs — finishing, orientation, burst I/O, timing —
against the JAX package, on the CPU.

``process_arrays`` runs on the ISO-keyed path (``iso=100``, no alpha/beta:
the curves come from the repo's ``data/``), which is deterministic, with the
JAX reference on its scan pipeline, tiled merge and device finishing.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import ALPHA, BETA, kernel_counts, n, t  # noqa: E402

from hmsr_tpu.finishing import apply_orientation as j_orient  # noqa: E402
from hmsr_tpu.finishing import device as j_fin  # noqa: E402
from hmsr_tpu.io import burst as j_io  # noqa: E402
from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models.process import process_arrays as j_process_arrays  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.finishing import apply_orientation, device as fin  # noqa: E402
from hmsr_tpu_torch.io import burst as io  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402

SIZE = 128
SHARPEN = {"enabled": True, "amount": 1.5, "radius": 3}


def _tune(c, finishing):
    """Two pyramid levels (the default's finest two), SNR-based tile size and
    merge constants, x2; the default finishing (sharpening + gamma) on or
    off."""
    c.scale = 2
    c.verbose = 0
    c.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],
                                   search_radii=[1, 4], metrics=["L1", "L2"])
    c.postprocessing.enabled = finishing
    return c


def jax_config(finishing):
    from hmsr_tpu.configs import default_config
    c = _tune(default_config(), finishing)
    c.tpu.update(pipeline="scan", merge_impl="tiled", finishing_impl="device")
    return c


def port_config(finishing, pipeline="scan"):
    c = _tune(configs.default_config(), finishing)
    c["tpu"] = {"pipeline": pipeline, "merge_chunk": 3}
    return c


@pytest.fixture(scope="module")
def burst():
    ref, comps, _, _ = make_synthetic_burst(SIZE, SIZE, n_frames=5, seed=6)
    return ref, comps


@pytest.fixture(scope="module")
def results(burst):
    """JAX and port ``process_arrays`` with finishing off and on; the port
    with finishing on runs chunked (bit-identical to scan)."""
    ref, comps = burst
    out = {}
    for finishing in (False, True):
        jc, pc = jax_config(finishing), port_config(finishing,
                                                    "chunked" if finishing else "scan")
        out[finishing] = (j_process_arrays(ref, comps, jc, iso=100),
                          P.process_arrays(ref, comps, pc, iso=100, device="cpu"),
                          jc, pc)
    return out


def test_process_arrays_no_finishing(results):
    """The linear image: the e2e criteria on the interior, the accumulated
    robustness within the per-frame tolerance times the frame count, and the
    configuration resolved as the JAX package resolves it."""
    (img_j, dbg_j), (img_t, dbg_t), jc, pc = results[False]
    assert tuple(img_t.shape) == (2 * SIZE, 2 * SIZE, 3)
    d = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3
    d_acc = np.abs(n(dbg_t["accumulated_robustness"])
                   - np.asarray(dbg_j["accumulated_robustness"]))
    assert d_acc.max() < 1e-3 * 4
    assert pc.noise_model.alpha == jc.noise_model.alpha       # fit_alpha_beta
    assert pc.block_matching.tuning.tile_size == jc.block_matching.tuning.tile_size
    for k in ("k_detail", "k_denoise", "D_th", "D_tr"):
        assert abs(pc.merging.tuning[k] - jc.merging.tuning[k]) < 1e-6
    assert kernel_counts() == (0,) * 8


def test_process_arrays_with_finishing(results):
    """Sharpening (amount a) and gamma on top. The unsharp mask
    ``x + a (x - blur x)`` grows a difference of the linear images by at
    most 1 + 2a, and its blur (radius int(4*3 + 0.5) = 12) carries the
    border's differences 12 pixels inwards, so the interior is cropped by
    8 + 12. With delta = (1 + 2a) * 1e-3, and x_lo the lower of the two
    linear values of a pixel, the gamma curve y = x^(1/2.2) (concave,
    increasing) bounds the difference of the outputs by
    (x_lo + delta)^(1/2.2) - x_lo^(1/2.2): the curve's slope at x_lo spent
    over delta. The linear values are recovered as y^2.2."""
    (img_j, _), (img_t, _), _, _ = results[True]
    _check_finishing(img_t, img_j)


@pytest.mark.parametrize("variant", ["grey", "merge_denoiser"])
def test_process_arrays_variants_with_finishing(burst, variant):
    """``process_arrays`` with the device finishing in grey mode (the
    one-channel image repeated to three before the finishing) and with the
    accumulated-robustness merge denoiser (``process_burst`` enables the
    denoiser, whose only effect is in the reference-frame merge), against the
    JAX package with :func:`test_process_arrays_with_finishing`'s bounds."""
    ref, comps = burst
    jc, pc = jax_config(True), port_config(True)
    for c in (jc, pc):
        if variant == "grey":
            c.mode = "grey"
        else:
            c.accumulated_robustness_denoiser.merge.enabled = True
    img_j, dbg_j = j_process_arrays(ref, comps, jc, iso=100)
    img_t, dbg_t = P.process_arrays(ref, comps, pc, iso=100, device="cpu")
    assert tuple(img_t.shape) == (2 * SIZE, 2 * SIZE, 3)
    assert pc.accumulated_robustness_denoiser.enabled == (variant == "merge_denoiser")
    assert dbg_t.keys() == dbg_j.keys()
    _check_finishing(img_t, img_j)
    assert kernel_counts() == (0,) * 8


def _check_finishing(img_t, img_j):
    crop = slice(8 + 12, -(8 + 12))
    y_t, y_j = n(img_t)[crop, crop].astype(np.float64), \
        np.asarray(img_j)[crop, crop].astype(np.float64)
    gain = 1 + 2 * SHARPEN["amount"]
    delta = gain * 1e-3
    x_lo = np.minimum(y_t, y_j) ** 2.2
    tol = (x_lo + delta) ** (1 / 2.2) - x_lo ** (1 / 2.2)
    assert np.all(np.abs(y_t - y_j) <= tol)
    d_lin = np.abs(y_t ** 2.2 - y_j ** 2.2)
    assert d_lin.mean() < gain * 1e-4 and d_lin.max() < delta
    assert 0.0 <= float(img_t.min()) and float(img_t.max()) <= 1.0


@pytest.mark.parametrize("cc,tm,gamma,dv", [(False, False, True, False),
                                            (True, False, True, False),
                                            (False, True, False, True),
                                            (True, True, True, True)])
def test_postprocess_device_against_jax(cc, tm, gamma, dv):
    """The finishing chain alone, within 1e-5 (float32 convolutions summed in
    another order)."""
    rng = np.random.RandomState(7)
    img = (rng.rand(65, 47, 3) * 1.2 - 0.1).astype(np.float32)
    xyz2cam = np.array([[1.2, -0.1, 0.0], [-0.2, 1.1, 0.1], [0.0, 0.2, 0.9]])
    kw = dict(do_color_correction=cc, do_tonemapping=tm, do_gamma=gamma,
              sharpening_config=SHARPEN, do_devignette=dv, xyz2cam=xyz2cam)
    want = np.asarray(j_fin.make_postprocess_device(**kw)(jnp.asarray(img)))
    got = fin.make_postprocess_device(**kw)(t(img))
    assert np.abs(n(got) - want).max() <= 1e-5


@pytest.mark.parametrize("sigma", [1.0, 3, 4.2])
def test_gaussian_blur_nearest_against_jax(sigma):
    img = np.random.RandomState(3).rand(40, 33, 3).astype(np.float32)
    want = np.asarray(j_fin.gaussian_blur_nearest(jnp.asarray(img), sigma))
    assert np.abs(n(fin.gaussian_blur_nearest(t(img), sigma)) - want).max() <= 1e-6


@pytest.mark.parametrize("ori", range(1, 9))
def test_apply_orientation_exact(ori):
    rng = np.random.RandomState(ori)
    for shape in ((6, 8, 3), (5, 7)):
        a = rng.rand(*shape).astype(np.float32)
        np.testing.assert_array_equal(n(apply_orientation(t(a), ori)),
                                      j_orient(a, ori))


def test_npz_burst_round_trip(tmp_path):
    """The port's bundle writer and both loaders agree."""
    rng = np.random.RandomState(0)
    frames = rng.rand(3, 16, 20).astype(np.float32)
    path = str(tmp_path / "burst.npz")
    io.save_npz_burst(path, frames, DEFAULT_CFA, [2.0, 1.0, 1.5], iso=400,
                      alpha=ALPHA, beta=BETA, xyz2cam=np.eye(3), orientation=6)
    got, want = io.load_burst(path), j_io.load_burst(path)
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, f


def test_dng_branch_without_rawpy(tmp_path):
    """A folder without bundles goes to the DNG reader, which needs
    rawpy/exifread and raises as the JAX package does without them."""
    try:
        import exifread  # noqa: F401
        import rawpy  # noqa: F401
        have = True
    except ImportError:
        have = False
    if have:
        with pytest.raises(ValueError):          # no .dng in the folder
            io.load_burst(tmp_path)
        return
    with pytest.raises(ImportError) as got:
        io.load_burst(tmp_path)
    with pytest.raises(ImportError) as want:
        j_io.load_burst(tmp_path)
    assert str(got.value) == str(want.value)


def test_normalize_burst_matches_jax():
    from hmsr_tpu.io.native_loader import normalize_burst
    from hmsr_tpu_torch.io.native_loader import normalize_burst as port_normalize
    raw = np.random.RandomState(1).randint(60, 1023, (2, 8, 10)).astype(np.uint16)
    args = ([[2, 1], [1, 0]], [64, 60, 62, 60], 1023, [1.9, 1.0, 1.4, 1.0])
    np.testing.assert_allclose(n(port_normalize(raw, *args, device="cpu")),
                               normalize_burst(raw, *args), rtol=1e-6)


def test_timer_and_gettime(capsys):
    from hmsr_tpu_torch.utils.timing import getTime, timer
    calls = []
    fn = timer(lambda x: calls.append(x) or x * 2, True, start_s="start", end_s="end")
    assert int(fn(torch.ones(()))) == 2 and len(calls) == 1
    assert timer(len, False) is len
    getTime(0.0, "label")
    out = capsys.readouterr().out
    assert "start" in out and "end" in out and "label" in out and "milliseconds" in out


def test_process_npz_verbose_profile(tmp_path, capsys, monkeypatch):
    """``process`` on a bundle with its own noise profile: verbose 3 prints
    the stage trace, ``tpu.profile_dir`` writes a torch.profiler trace, and
    the orientation turns the image and the accumulated robustness."""
    from hmsr_tpu_torch.noise import fast_monte_carlo
    monkeypatch.setattr(fast_monte_carlo, "DISK_CACHE_DIR", str(tmp_path / "cache"))
    ref, comps, _, _ = make_synthetic_burst(64, 96, n_frames=3, seed=2)
    path = str(tmp_path / "b.npz")
    io.save_npz_burst(path, np.concatenate([ref[None], comps]), DEFAULT_CFA,
                      [1.0, 1.0, 1.0], alpha=ALPHA, beta=BETA, orientation=6)
    c = port_config(True)
    c.verbose = 3
    c.tpu["profile_dir"] = str(tmp_path / "prof")
    img, dbg = P.process(path, c, device="cpu")
    assert tuple(img.shape) == (192, 128, 3)                  # rotated 90
    assert tuple(dbg["accumulated_robustness"].shape) == (96, 64)
    assert os.listdir(tmp_path / "prof")
    # the whole call, upload to orientation, with the program's spans
    with open(tmp_path / "prof" / "pipeline_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"hmsr::process.upload", "hmsr::merge", "hmsr::process.orientation"} <= names
    out = capsys.readouterr().out
    assert "--- Merge (one frame)" in out and "Estimated SNR" in out
    assert c.noise_model.alpha == ALPHA                        # the bundle's


def test_entry_points_default_to_the_card(tmp_path):
    """Without a device the entry points run on CUDA; on a host without it
    they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from hmsr_tpu_torch.models.pipeline import make_pipeline
    frames = np.zeros((3, 64, 64), np.float32)
    burst = io.Burst(frames[0], frames[1:], 100, DEFAULT_CFA, None, [1.0, 1.0, 1.0],
                     ALPHA, BETA, 1, None)
    path = str(tmp_path / "b.npz")
    io.save_npz_burst(path, frames, DEFAULT_CFA, [1.0, 1.0, 1.0])
    for call in (lambda: make_pipeline(port_config(False), DEFAULT_CFA, [1, 1, 1]),
                 lambda: P.process_arrays(frames[0], frames[1:], port_config(False)),
                 lambda: P.process_burst(burst, port_config(False)),
                 lambda: P.process(path, port_config(False))):
        with pytest.raises(RuntimeError):
            call()


def test_make_burst_brightness():
    """The dark cells' bursts: the scene is scaled to [0.2, 1.8] x the
    brightness, so the mean sits near it."""
    from hmsr_tpu_torch import synthetic
    for b in (0.07, 0.02):
        fr = synthetic.make_burst(64, 64, 2, 0, "cpu", brightness=b)
        assert abs(float(fr.mean()) - b) < 0.25 * b
    assert torch.equal(synthetic.make_burst(32, 32, 2, 1, "cpu"),
                       synthetic.make_burst(32, 32, 2, 1, "cpu", brightness=None))


def test_process_arrays_no_noise_model_raises():
    frames = np.zeros((3, 64, 64), np.float32)
    with pytest.raises(ValueError):
        P.process_arrays(frames[0], frames[1:], port_config(False), iso=None,
                         device="cpu")
