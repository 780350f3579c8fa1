"""The port's scan pipeline end to end against the JAX package's, and the
port's boundaries (no JAX, no hidden CPU fallback, no silent path swap).

E2E criteria (tools/verify_e2e_parity.py): flow max|d| < 1e-2, image
mean|d| < 1e-4 and max|d| < 1e-3 on the interior [8:-8, 8:-8].
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import WB, curves, default_config, kernel_counts, n, small_config  # noqa: E402,E501

from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu.models.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from hmsr_tpu_torch.models.pipeline import make_pipeline  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _e2e_config(cfg):
    """The configurations of :func:`test_e2e_against_jax_scan`: the 2-level
    small configuration at 128^2 (Ts 16 unless the id names another) with
    the changes the id names, or the ``bench.py`` configuration at 256^2.
    Returns ``(size, config)``."""
    if cfg == "256-default":
        return 256, default_config(256)       # 4 levels, Ts=16
    config = small_config(128, int(cfg[-2:]) if cfg.startswith("128-ts") else 16)
    if "grey" in cfg:                         # bench.py's grey cell
        config.mode = "grey"
    if "iso" in cfg:
        config.merging.kernel = "iso"
    if "x3" in cfg:                           # bench.py's x3 cell
        config.scale = 3
        config.accumulated_robustness_denoiser.enabled = True
    if "x1" in cfg:                           # bench.py's x1 cell
        config.scale = 1
        config.robustness.enabled = False
        config.robustness.save_mask = False
    return 128, config


@pytest.mark.parametrize("cfg", ["128-ts16", "128-ts32", "256-default", "128-grey",
                                 "128-grey-iso", "128-iso", "128-x3-denoiser", "128-x1"])
def test_e2e_against_jax_scan(cfg):
    """The port's scan pipeline against the JAX scan pipeline: the Bayer
    main path, grey mode, the isotropic kernel, ``bench.py``'s x3 cell (the
    accumulated-robustness denoiser in the reference merge) and its x1 cell
    (robustness off).

    Grey mode with the steerable kernel holds against the JAX pipeline
    without its outer ``jit`` (its frame loop still compiled): compiled as
    one program, XLA's CPU code for the reference frame's
    ``estimate_kernels`` moves the covariance at raw pixel (17, 8) of this
    burst by 0.17 against the same function evaluated op by op (the
    structure tensor there is nearly isotropic), and the image by 4.1e-3;
    the port agrees with the op-by-op covariances within 2.6e-6."""
    size, config = _e2e_config(cfg)
    config.debug = True
    ref, comps, _, _ = make_synthetic_burst(size, size, n_frames=4, seed=0)
    std, diff = curves()
    img_j, dbg_j = j_make_pipeline(config, DEFAULT_CFA, WB, jit=cfg != "128-grey")(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))
    img_t, dbg_t = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)

    s = int(config.scale)
    assert tuple(img_t.shape) == (s * size, s * size, 3 if config.mode == "bayer" else 1)
    d_flow = np.abs(n(dbg_t["flow"]) - np.asarray(dbg_j["flow"]))
    d_img = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d_flow.max() < 1e-2
    assert d_img.mean() < 1e-4
    assert d_img.max() < 1e-3
    # robustness (in grey mode on the raw frame: one channel, no upscale)
    assert np.abs(n(dbg_t["robustness"]) - np.asarray(dbg_j["robustness"])).max() < 1e-3
    assert dbg_t.keys() == dbg_j.keys()
    if config.robustness.save_mask:
        # on by default: the sum of the 3 frames' maps, within the
        # per-frame robustness tolerance times the number of frames
        d_acc = np.abs(n(dbg_t["accumulated_robustness"])
                       - np.asarray(dbg_j["accumulated_robustness"]))
        assert d_acc.max() < 1e-3 * len(comps)
    assert kernel_counts() == (0,) * 8     # CPU tensors: plain versions only


@pytest.mark.parametrize("cfg", ["128-grey", "128-x3-denoiser"])
def test_chunked_equals_scan_variants(cfg):
    """The chunked pipeline (chunks of 2) equals the port's scan pipeline
    exactly in grey mode and in ``bench.py``'s x3 cell, whose reference merge
    reads the accumulated robustness of the chunked analysis."""
    size, config = _e2e_config(cfg)
    ref, comps, _, _ = make_synthetic_burst(size, size, n_frames=4, seed=5)
    std, diff = curves()
    img_s, dbg_s = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    config.tpu.pipeline = "chunked"
    config.tpu.merge_chunk = 2
    img_c, dbg_c = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    assert torch.equal(img_c, img_s)
    assert torch.equal(dbg_c["accumulated_robustness"], dbg_s["accumulated_robustness"])
    assert kernel_counts() == (0,) * 8


def test_chunked_against_jax_scan_and_port_scan():
    """The chunked pipeline (4 frames in chunks of 3 and 1: one burst merge
    of each length) against the JAX scan pipeline with the e2e criteria, and
    against the port's own scan pipeline exactly."""
    size = 128
    config = small_config(size)
    config.debug = True
    ref, comps, _, _ = make_synthetic_burst(size, size, n_frames=5, seed=3)
    std, diff = curves()
    img_j, dbg_j = j_make_pipeline(config, DEFAULT_CFA, WB)(
        jnp.asarray(ref), jnp.asarray(comps), jnp.asarray(std), jnp.asarray(diff))
    img_s, dbg_s = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)
    config.tpu.pipeline = "chunked"
    config.tpu.merge_chunk = 3
    img_c, dbg_c = make_pipeline(config, DEFAULT_CFA, WB, "cpu")(ref, comps, std, diff)

    assert torch.equal(img_c, img_s)
    assert dbg_c.keys() == dbg_s.keys() == {"flow", "robustness", "accumulated_robustness"}
    assert all(torch.equal(dbg_c[k], dbg_s[k]) for k in dbg_s)
    d_img = np.abs(n(img_c) - np.asarray(img_j))[8:-8, 8:-8]
    assert np.abs(n(dbg_c["flow"]) - np.asarray(dbg_j["flow"])).max() < 1e-2
    assert d_img.mean() < 1e-4
    assert d_img.max() < 1e-3
    assert kernel_counts() == (0,) * 8


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter: import the port, run the 128^2 slice on the
    CPU with the port's own configuration and burst, then ``process_arrays``
    on it (Monte-Carlo noise curves, finishing, orientation); neither JAX nor
    the JAX package may be loaded."""
    code = (
        "import sys, numpy as np\n"
        "import hmsr_tpu_torch\n"
        "from hmsr_tpu_torch.models.pipeline import make_pipeline\n"
        "from hmsr_tpu_torch import configs, convert, synthetic as syn\n"
        "frames = syn.make_burst(128, 128, 3, 0, 'cpu')\n"
        "std, diff = syn.affine_curves()\n"
        "config = configs.default_config()\n"
        "config.scale = 2\n"
        "config.noise_model.update(alpha=syn.ALPHA, beta=syn.BETA)\n"
        "config.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],\n"
        "    search_radii=[1, 4], metrics=['L1', 'L2'])\n"
        "configs.update_snr_config(config, 40)\n"
        "configs.sanitize_config(config, (128, 128))\n"
        "img, _ = make_pipeline(config, syn.CFA_RGGB, syn.WB, 'cpu')"
        "(frames[0], frames[1:], std, diff)\n"
        "assert tuple(img.shape) == (256, 256, 3)\n"
        "assert bool(np.isfinite(img[8:-8, 8:-8].numpy()).all())\n"
        "from hmsr_tpu_torch.models.process import process_arrays\n"
        "from hmsr_tpu_torch.noise import fast_monte_carlo\n"
        "fast_monte_carlo.DISK_CACHE_DIR = sys.argv[1]\n"
        "config = configs.default_config()\n"
        "config.update(scale=2, verbose=0, tpu={'pipeline': 'chunked'})\n"
        "config.noise_model.update(alpha=syn.ALPHA, beta=syn.BETA)\n"
        "config.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],\n"
        "    search_radii=[1, 4], metrics=['L1', 'L2'])\n"
        "img, dbg = process_arrays(frames[0], frames[1:], config, orientation=6,\n"
        "                          device='cpu')\n"
        "assert tuple(img.shape) == (256, 256, 3), img.shape\n"
        "assert tuple(dbg['accumulated_robustness'].shape) == (128, 128)\n"
        "assert 0 <= float(img.min()) and float(img.max()) <= 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'hmsr_tpu')]\n"
        "assert not bad, bad\n"
        "print('NOJAX-OK')\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOJAX-OK" in res.stdout


def test_chip_smoke_imports_no_reference():
    """chip_smoke.py's imports load neither JAX nor the JAX package, and
    its own check of that passes."""
    code = ("import sys, chip_smoke\n"
            "chip_smoke.check_no_reference_imports()\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'hmsr_tpu')]\n"
            "print('NOREF-OK')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOREF-OK" in res.stdout


@pytest.mark.parametrize("snr", [5.0, 14.0, 18.0, 22.5, 40.0])
def test_port_config_matches_jax(snr):
    """The port's configuration tree, SNR resolution and validation give the
    JAX package's values (its ``tpu:`` switches aside)."""
    from hmsr_tpu import configs as j_configs
    from hmsr_tpu_torch import configs
    port, ref = configs.default_config(), j_configs.default_config()
    ref.pop("tpu")
    assert port == ref
    for c, mod in ((port, configs), (ref, j_configs)):
        mod.update_snr_config(c, snr)
        mod.sanitize_config(c, (3000, 4000))
    assert port == ref
    for c, mod in ((port, configs), (ref, j_configs)):
        c.ica.tuning.n_iter = 0
        with pytest.raises((AssertionError, ValueError)):
            mod.sanitize_config(c, (3000, 4000))
    tiny = configs.update_snr_config(configs.default_config(), snr)
    with pytest.raises(ValueError):
        configs.sanitize_config(tiny, (64, 64))


def test_synthetic_burst():
    """The port's burst maker: seeded, frame 0 unshifted, values in [0, 1],
    and its analytic curves equal the test helpers'."""
    from hmsr_tpu_torch import synthetic
    a = synthetic.make_burst(64, 96, 3, 7, "cpu")
    b = synthetic.make_burst(64, 96, 3, 7, "cpu")
    assert tuple(a.shape) == (3, 64, 96) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    for got, want in zip(synthetic.affine_curves(), curves()):
        np.testing.assert_array_equal(got, want)
    assert synthetic.burst_config((3000, 4000), 51.9).block_matching.tuning.tile_size == 16


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError):
        make_pipeline(small_config(128), DEFAULT_CFA, WB, "cuda")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


PROCESS_CHANGES = ["mesh"]


@pytest.mark.parametrize("change", ["unknown_pipeline", "chunked_fractional"]
                         + PROCESS_CHANGES)
def test_unported_configurations_raise(change):
    """An unknown ``tpu.pipeline`` form raises ``NotImplementedError`` in
    ``make_pipeline`` (every form of the JAX package is ported); the chunked
    form at a fractional scale raises ``ValueError``, as in the JAX package;
    a mesh, which only the process layer reads, raises ``RuntimeError`` in
    ``process_arrays`` before any work when no ``torch.distributed``
    process group of its size runs (it never falls back to one device)."""
    config = small_config(128)
    if change == "unknown_pipeline":
        config.tpu.pipeline = "pipelined"
    elif change == "chunked_fractional":
        config.tpu.pipeline = "chunked"
        config.scale = 1.5
    elif change == "mesh":
        config.tpu.mesh = [2, 1]
    expected = {"mesh": (RuntimeError, "torch.distributed"),
                "chunked_fractional": (ValueError, "integer scale")}.get(
                    change, (NotImplementedError, "pipelined"))
    with pytest.raises(expected[0], match=expected[1]):
        if change in PROCESS_CHANGES:
            from hmsr_tpu_torch.models.process import process_arrays
            frames = np.zeros((3, 128, 128), np.float32)
            process_arrays(frames[0], frames[1:], config, device="cpu")
        else:
            make_pipeline(config, DEFAULT_CFA, WB, "cpu")
