"""The port's user entry points against the JAX package, on the CPU: the
command line ``python -m hmsr_tpu_torch.run_handheld`` (configuration
files and overrides, the parameter banner, the outputs and their writers)
and the single-device entry ``hmsr_tpu_torch.graft_entry``.

The CLI runs in a subprocess with ``HMSR_FORCE_CPU=1`` on a 128x128 4-frame
bundle; its PNG is held against JAX ``process`` (scan pipeline) quantised
the same way: under 0.1 % of the values may differ by more than one step.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import block_imports, curves, kernel_counts, n  # noqa: E402

import run_handheld as j_cli  # noqa: E402
from hmsr_tpu import configs as j_configs  # noqa: E402
from hmsr_tpu.io.burst import save_npz_burst  # noqa: E402
from hmsr_tpu.io.synthetic import DEFAULT_CFA, make_synthetic_burst  # noqa: E402
from hmsr_tpu_torch import configs, graft_entry  # noqa: E402
from hmsr_tpu_torch import run_handheld as cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

YAML = """\
scale: 2
verbose: 0
block_matching:
  tuning:
    factors: [1, 2]
    tile_size_factors: [1, 1]
noise_model:
  alpha: null
postprocessing:
  sharpening: {amount: 1.2}
extra:
  note: a string
"""
OVERRIDES = ["block_matching.tuning.search_radii=[1,4]",
             "block_matching.tuning.metrics=['L1','L2']",
             "robustness.save_mask=True", "merging.tuning.k_stretch=4.5"]

#: the child's wrapper: run the CLI, then check that it loaded no JAX
RUN_CLI = ("import sys\n"
           "from hmsr_tpu_torch.run_handheld import main\n"
           "main()\n"
           "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hmsr_tpu')]\n"
           "assert not bad, bad\n"
           "print('NOJAX-OK')\n")


def _apply(mod, base, yaml_path, overrides, parse):
    c = mod.merge(base, mod.load_yaml(yaml_path))
    for item in overrides:
        key, value = item.split("=", 1)
        mod.update(c, key, parse(value))
    return c


def test_config_tree_against_jax(tmp_path):
    """``load_yaml``, ``merge`` and ``update`` give the JAX package's tree on
    the same YAML text and overrides (new nodes, a leaf replaced by a node, a
    node by a leaf); the base is left as it was."""
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    assert configs.load_yaml(path) == j_configs.load_yaml(path)
    extra = OVERRIDES + ["new.branch.leaf=3", "scale.sub=1", "postprocessing=False"]
    base, j_base = configs.default_config(), j_configs.default_config()
    j_base.pop("tpu")
    got = _apply(configs, base, path, extra, cli.parse_value)
    want = _apply(j_configs, j_base, path, extra, j_cli.parse_value)
    assert got == want
    assert got.block_matching.tuning.metrics == ["L1", "L2"]
    assert got.postprocessing is False and got.scale == {"sub": 1}
    assert base == configs.default_config()
    empty = tmp_path / "empty.yaml"
    empty.write_text("")
    assert configs.load_yaml(empty) == {} == j_configs.load_yaml(empty)


def test_load_yaml_without_pyyaml(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    block_imports(monkeypatch, "yaml")
    with pytest.raises(ImportError, match="pyyaml"):
        configs.load_yaml(path)


@pytest.mark.parametrize("value", ["true", "No", "1", "0", "3", "2.5", "[1,2]",
                                   "'L1'", "None", "open('x')", "abc", "{'a': 1}"])
def test_parse_value_against_jax(value):
    assert cli.parse_value(value) == j_cli.parse_value(value)
    with pytest.raises(TypeError):
        cli.str2bool("maybe")


@pytest.mark.parametrize("change", ["default", "x1", "x3-denoiser", "robustness-off",
                                    "fixed-merge"])
def test_print_parameters_against_jax(change):
    """The parameter banner is the JAX CLI's, line for line."""
    trees = []
    for mod in (configs, j_configs):
        c = mod.default_config()
        if change == "x1":
            c.scale = 1
        elif change == "x3-denoiser":
            c.scale = 3
            c.accumulated_robustness_denoiser.merge.enabled = True
            c.noise_model.update({"alpha": 1e-4, "beta": 2e-6})
        elif change == "robustness-off":
            c.robustness.enabled = False
        elif change == "fixed-merge":
            c.merging.tuning.k_detail = 0.3
            c.merging.tuning.k_denoise = 4.0
        trees.append(c)
    out = []
    for fn, c in ((cli.print_parameters, trees[0]), (j_cli.print_parameters, trees[1])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(c)
        out.append(buf.getvalue())
    assert out[0] == out[1] and "Upscaling factor" in out[0]


def _read_png(path, reader):
    if reader == "cv2":
        import cv2
        return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_UNCHANGED),
                            cv2.COLOR_BGR2RGB)
    from PIL import Image
    with Image.open(path) as im:
        assert im.mode == "RGB"
        return np.asarray(im)


@pytest.mark.parametrize("reader", ["PIL", "cv2"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 97)])
def test_write_png_round_trip(tmp_path, shape, reader):
    """The standard-library PNG decodes to the same bytes; its IHDR says
    8-bit RGB."""
    pytest.importorskip(reader)
    rgb = np.random.RandomState(shape[0]).randint(0, 256, shape + (3,)).astype(np.uint8)
    path = tmp_path / "x.png"
    cli.write_png(path, rgb)
    head = path.read_bytes()[:33]
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    assert int.from_bytes(head[16:20], "big") == shape[1]
    assert int.from_bytes(head[20:24], "big") == shape[0]
    assert head[24:26] == bytes([8, 2])
    np.testing.assert_array_equal(_read_png(path, reader), rgb)
    with pytest.raises(ValueError):
        cli.write_png(path, rgb.astype(np.float32))


def test_imsave_backends(tmp_path, monkeypatch):
    """cv2 first; without cv2, imageio and PIL, a PNG goes through the
    standard library and anything else raises."""
    rgb = np.random.RandomState(1).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    cli.imsave(tmp_path / "cv2.png", rgb)
    np.testing.assert_array_equal(_read_png(tmp_path / "cv2.png", "PIL"), rgb)
    block_imports(monkeypatch, "cv2", "imageio", "PIL")
    cli.imsave(tmp_path / "stdlib.png", rgb)
    with pytest.raises(ImportError):
        cli.imsave(tmp_path / "x.tif", rgb)
    monkeypatch.undo()
    np.testing.assert_array_equal(_read_png(tmp_path / "stdlib.png", "PIL"), rgb)
    assert not (tmp_path / "x.tif").exists()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A 128x128 4-frame bundle with ISO 100 and no noise profile (the
    noise curves come from the repo's ``data/``: deterministic)."""
    d = tmp_path_factory.mktemp("cli")
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4, seed=1)
    path = d / "burst.npz"
    save_npz_burst(path, np.concatenate([ref[None], comps]), DEFAULT_CFA, [1, 1, 1],
                   iso=100)
    (d / "c.yaml").write_text(YAML)
    return d, path


def test_cli_png_against_jax(bundle, tmp_path):
    """The port's CLI in a subprocess on the CPU (``--config`` and overrides):
    exit 0, no JAX loaded, the PNG against JAX ``process`` on the scan
    pipeline quantised the same way, and the robustness mask beside it."""
    from hmsr_tpu.models.process import process as j_process
    d, path = bundle
    out = tmp_path / "out.png"
    env = dict(os.environ, HMSR_FORCE_CPU="1", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", RUN_CLI, "--impath", str(path),
                          "--outpath", str(out), "--config", str(d / "c.yaml"),
                          *OVERRIDES, "tpu.pipeline=scan"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX-OK" in res.stdout and "Upscaling factor" in res.stdout
    got = _read_png(out, "PIL")
    rob = _read_png(out.with_suffix(".rob.png"), "PIL")
    assert got.shape == rob.shape == (256, 256, 3)

    jc = _apply(j_configs, j_configs.default_config(), d / "c.yaml", OVERRIDES,
                j_cli.parse_value)
    jc.tpu.update(pipeline="scan", merge_impl="tiled", finishing_impl="device")
    img, dbg = j_process(str(path), jc)
    want = (np.clip(np.nan_to_num(np.asarray(img)), 0, 1) * 255 + 0.5).astype(np.uint8)
    step = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (step > 1).mean() < 1e-3, (step > 1).mean()
    acc = np.asarray(dbg["accumulated_robustness"])
    acc = (acc / acc.max() * 255 + 0.5).astype(np.int32)
    acc = np.repeat(np.repeat(acc, 2, 0), 2, 1)
    assert (np.abs(rob[..., 0].astype(np.int32) - acc) > 1).mean() < 1e-3


def _main(monkeypatch, argv, force_cpu=True):
    monkeypatch.setattr(sys, "argv", ["run_handheld", *argv])
    if force_cpu:
        monkeypatch.setenv("HMSR_FORCE_CPU", "1")
    else:
        monkeypatch.delenv("HMSR_FORCE_CPU", raising=False)
    cli.main()


def test_cli_needs_the_card(bundle, tmp_path, monkeypatch):
    """Without ``HMSR_FORCE_CPU`` the CLI runs on the card, and raises on a
    host without one instead of carrying on on the CPU. A lone alpha or
    beta is refused before the banner (the JAX CLI's banner fails on a lone
    alpha with a ``TypeError`` before its own check)."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, path = bundle
    with pytest.raises(RuntimeError, match="CUDA"):
        _main(monkeypatch, ["--impath", str(path), "--outpath", str(tmp_path / "o.png")],
              force_cpu=False)
    for lone in ("noise_model.alpha=1e-4", "noise_model.beta=1e-6"):
        with pytest.raises(ValueError, match="alpha and beta"):
            _main(monkeypatch, ["--impath", str(path), "--outpath",
                                str(tmp_path / "o.png"), lone])
    assert not list(tmp_path.iterdir())


def test_cli_dng_output(bundle, tmp_path, monkeypatch):
    """A ``.dng`` output turns the finishing off and hands the linear image
    and the folder's first ``*.dng`` to ``save_as_dng``; without exiftool
    that raises, naming it."""
    from hmsr_tpu_torch.io import dng
    d, path = bundle
    folder = tmp_path / "burst"
    folder.mkdir()
    os.symlink(path, folder / "burst.npz")
    (folder / "ref.dng").write_bytes(b"")
    calls = []
    monkeypatch.setattr(dng, "save_as_dng", lambda *a: calls.append(a))
    argv = ["--impath", str(folder), "--outpath", str(tmp_path / "out.dng"),
            "--config", str(d / "c.yaml"), *OVERRIDES[:2]]
    _main(monkeypatch, argv)
    img, ref, out = calls[0]
    assert img.shape == (256, 256, 3) and 0 <= img.min() and img.max() <= 1
    assert str(ref) == str(folder / "ref.dng") and str(out) == str(tmp_path / "out.dng")
    monkeypatch.undo()
    monkeypatch.setattr(dng, "EXIFTOOL_PATH", str(tmp_path / "no-exiftool"))
    with pytest.raises(RuntimeError, match="exiftool"):
        _main(monkeypatch, argv)


def test_graft_entry_against_jax():
    """``graft_entry.entry(device="cpu")`` against the JAX package's entry
    configuration (``__graft_entry__._small_config``) on its default
    pipeline form (``auto``: the fused form off the TPU, the port's default
    too), with the e2e bounds (flow max|d| < 1e-2; image mean|d| < 1e-4 and
    max|d| < 1e-3 on the interior)."""
    from __graft_entry__ import _small_config
    from hmsr_tpu.models.pipeline import make_pipeline as j_make_pipeline
    from hmsr_tpu_torch.models.pipeline import pipeline_form
    fn, args = graft_entry.entry(device="cpu")
    ref, comps, std, diff = args
    assert tuple(ref.shape) == (128, 128) and tuple(comps.shape) == (3, 128, 128)
    np.testing.assert_array_equal(std.numpy(), curves()[0])
    np.testing.assert_array_equal(diff.numpy(), curves()[1])
    jc = _small_config()
    jc.debug = True
    pc = graft_entry.small_config()
    assert jc.tpu.pipeline == "auto" and pipeline_form(pc) == "fused"
    assert {k: v for k, v in jc.items() if k != "tpu"} == {**pc, "debug": True}
    img_j, dbg_j = j_make_pipeline(jc, DEFAULT_CFA, [1.0, 1.0, 1.0])(
        *(jnp.asarray(x.numpy()) for x in args))
    img_t, _ = fn(*args)
    assert tuple(img_t.shape) == (256, 256, 3)
    d = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3
    from hmsr_tpu_torch.models.pipeline import make_pipeline
    pc.debug = True
    _, dbg_t = make_pipeline(pc, DEFAULT_CFA, [1.0, 1.0, 1.0], "cpu")(*args)
    assert np.abs(n(dbg_t["flow"]) - np.asarray(dbg_j["flow"])).max() < 1e-2
    assert kernel_counts() == (0,) * 8


def test_new_modules_import_no_reference():
    """In a fresh interpreter the port's entry modules load neither JAX, the
    JAX package nor anything of ``tests/``."""
    code = ("import sys\n"
            "import hmsr_tpu_torch.configs, hmsr_tpu_torch.finishing.raw2rgb\n"
            "import hmsr_tpu_torch.finishing.unprocess, hmsr_tpu_torch.io.dng\n"
            "import hmsr_tpu_torch.io.unpack, hmsr_tpu_torch.run_handheld\n"
            "import hmsr_tpu_torch.graft_entry\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'hmsr_tpu', 'oracles', 'torch_port_helpers')]\n"
            "assert not bad, bad\n"
            "print('NOREF-OK')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOREF-OK" in res.stdout
