"""The port's output and raw-data tools against the JAX package, on the
CPU: MIPI RAW10/RAW12 unpacking (``io/unpack.py``, bit for bit against
``hmsr_tpu.io.native_loader``'s numpy path and its C library where built),
the 16-bit TIFF writer and the DNG writer's refusals (``io/dng.py``; the
tests run neither ``exiftool`` nor ``dng_validate``).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import block_imports  # noqa: E402

from hmsr_tpu.io import dng as j_dng  # noqa: E402
from hmsr_tpu.io import native_loader  # noqa: E402
from hmsr_tpu_torch.io import dng  # noqa: E402
from hmsr_tpu_torch.io.unpack import unpack_raw10, unpack_raw12  # noqa: E402

UNPACK = {"raw10": (unpack_raw10, native_loader.unpack_raw10, 4, 5),
          "raw12": (unpack_raw12, native_loader.unpack_raw12, 2, 3)}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("fmt", list(UNPACK))
def test_unpack_against_jax(fmt, native, monkeypatch):
    """Random packed bytes (with trailing bytes past the last group) give
    the reference's uint16 pixels bit for bit, through its numpy path and
    through its C library."""
    fn, j_fn, per_group, group_bytes = UNPACK[fmt]
    if not native:
        monkeypatch.setattr(native_loader, "_load", lambda: None)
    elif native_loader._load() is None:
        pytest.skip("the JAX package's C loader (native/libburst.so) is not built")
    n_pixels = per_group * 1201
    packed = np.random.RandomState(4).randint(0, 256, n_pixels // per_group
                                              * group_bytes + 7).astype(np.uint8)
    want = j_fn(packed, n_pixels)
    got = fn(torch.from_numpy(packed), n_pixels)
    assert got.dtype == torch.uint16 and tuple(got.shape) == (n_pixels,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.to(torch.int32).max()) < 2 ** (10 if fmt == "raw10" else 12)


@pytest.mark.parametrize("fmt", list(UNPACK))
def test_unpack_refuses_bad_input(fmt):
    fn, _, per_group, group_bytes = UNPACK[fmt]
    with pytest.raises(TypeError):
        fn(torch.zeros(group_bytes, dtype=torch.int32), per_group)
    with pytest.raises(ValueError):
        fn(torch.zeros(group_bytes, dtype=torch.uint8), 2 * per_group)


def test_save_as_tiff_round_trip(tmp_path):
    """The 16-bit RGB TIFF reads back as the same array, under the ``.tif``
    suffix whatever the path's, uncompressed (a flat image takes at least its
    raw bytes). The JAX package's writer passes ``bigtiff=False``, which
    imageio refuses without the tifffile package."""
    imageio = pytest.importorskip("imageio")
    rng = np.random.RandomState(2)
    for img in (rng.randint(0, 2 ** 16, (21, 34, 3)).astype(np.uint16),
                np.full((40, 30, 3), 4321, np.uint16)):
        dng.save_as_tiff(img, tmp_path / "port.dng")
        got = imageio.v3.imread(tmp_path / "port.tif")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, img)
        assert (tmp_path / "port.tif").stat().st_size >= img.nbytes
    assert not (tmp_path / "port.dng").exists()


@pytest.mark.parametrize("missing", ["exiftool", "dng_validate"])
def test_save_as_dng_missing_tool(tmp_path, monkeypatch, missing):
    """A missing tool raises ``RuntimeError`` naming it, before any work, as
    in the JAX package."""
    present = sys.executable                   # any program on the path
    for mod in (dng, j_dng):
        monkeypatch.setattr(mod, "EXIFTOOL_PATH", present)
        monkeypatch.setattr(mod, "DNG_VALIDATE_PATH", present)
        attr = "EXIFTOOL_PATH" if missing == "exiftool" else "DNG_VALIDATE_PATH"
        monkeypatch.setattr(mod, attr, str(tmp_path / "no-such-tool"))
    img = np.zeros((4, 4, 3), np.float32)
    for mod in (dng, j_dng):
        with pytest.raises(RuntimeError, match=missing):
            mod.save_as_dng(img, tmp_path / "ref.dng", tmp_path / "out.dng")
    assert not list(tmp_path.iterdir())


def test_save_as_dng_missing_rawpy(tmp_path, monkeypatch):
    """With both tools present and no rawpy: ``RuntimeError``, as in the JAX
    package; an image that is not (H, W, 3) is refused first."""
    block_imports(monkeypatch, "rawpy")
    for mod in (dng, j_dng):
        monkeypatch.setattr(mod, "EXIFTOOL_PATH", sys.executable)
        monkeypatch.setattr(mod, "DNG_VALIDATE_PATH", sys.executable)
        with pytest.raises(RuntimeError, match="rawpy"):
            mod.save_as_dng(np.zeros((4, 4, 3), np.float32), tmp_path / "ref.dng",
                            tmp_path / "out.dng")
    with pytest.raises(ValueError):
        dng.save_as_dng(np.zeros((4, 4), np.float32), tmp_path / "ref.dng",
                        tmp_path / "out.dng")
