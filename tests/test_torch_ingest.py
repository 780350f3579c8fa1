"""The port's raw ingestion against the JAX package, on the CPU: the burst
normalizer and the RAW10/RAW12 unpackers (``io/native_loader.py``, the plain
versions of K8 and K9 in ``ops/cuda_ingest.py``) bit for bit against
``hmsr_tpu.io.native_loader`` (its C library and its numpy path), the DNG
loader of both packages on the same fake ``rawpy``/``exifread``
(``tests/test_dng_ingest.py``'s), ``process`` on a fake DNG folder against
the JAX package's, and the ``tpu.correlation`` switch.
"""

import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_dng_ingest import (BASE_TAGS, FakeExifread, FakeRatio, FakeRawpy,  # noqa: E402
                             FakeTag)
from torch_port_helpers import max_abs, n, small_config, t  # noqa: E402

from hmsr_tpu.io import burst as j_burst  # noqa: E402
from hmsr_tpu.io import native_loader as j_nl  # noqa: E402
from hmsr_tpu.models import alignment as j_align  # noqa: E402
from hmsr_tpu.models import block_matching as j_bm  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.io import burst, native_loader  # noqa: E402
from hmsr_tpu_torch.models import alignment, block_matching  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402
from hmsr_tpu_torch.ops import cuda_ingest  # noqa: E402

#: rawpy's patterns (3 = the second green) and the CFA after the loaders
#: unify the greens
RAWPY_CFA = {"RGGB": [[0, 1], [3, 2]], "BGGR": [[2, 3], [1, 0]],
             "GRBG": [[1, 0], [2, 3]], "GBRG": [[3, 2], [0, 1]]}
CFA = {k: np.where(np.asarray(v) == 3, 1, v) for k, v in RAWPY_CFA.items()}
#: (n, h, w): even, odd and one-pixel-high stacks
SHAPES = ((3, 8, 10), (2, 7, 9), (1, 1, 5))
WHITES = (1023, 4095, 65535)
WB = [2.0, 1.0, 1.5, 1.0]


def bits(a):
    """float32 values as their bit patterns (-0.0 differs from 0.0)."""
    return np.ascontiguousarray(n(a), dtype=np.float32).view(np.uint32)


def raw_stack(rng, shape):
    """uint16 over the whole range, 0 to 65535 (values of 32768 and above
    are negative as int16)."""
    frames = rng.randint(0, 65536, shape).astype(np.uint16)
    frames.flat[:2] = (0, 65535)
    return frames


@pytest.fixture
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(j_nl, "_load", lambda: None)


def jax_native():
    if j_nl._load() is None:
        pytest.skip("the JAX package's C loader (native/libburst.so) is not built")


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("layout", list(CFA))
def test_normalize_burst_against_jax(layout, native, monkeypatch):
    """Every CFA layout, odd shapes, values up to 65535 with blacks above
    many of them (negative outputs), white levels 1023, 4095 and 65535: bit
    for bit against the JAX package's C loader and its numpy path, from a
    numpy stack and from a uint16 tensor."""
    if native:
        jax_native()
    else:
        monkeypatch.setattr(j_nl, "_load", lambda: None)
    rng = np.random.RandomState(sum(map(ord, layout)))
    for shape in SHAPES:
        frames = raw_stack(rng, shape)
        for white in WHITES:
            black = [int(v) for v in rng.randint(0, 3000, 4)]
            args = (CFA[layout], black, white, WB)
            want = j_nl.normalize_burst(frames, *args)
            got = native_loader.normalize_burst(frames, *args, device="cpu")
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(bits(got), bits(want))
            got = native_loader.normalize_burst(torch.from_numpy(frames), *args,
                                                device="cpu")
            np.testing.assert_array_equal(bits(got), bits(want))
    assert cuda_ingest.normalize_bayer.launches == 0


def test_normalize_burst_channels(jax_numpy_path):
    """A CFA whose channels stop below 3 (nc = cfa.max() + 1) and a CFA
    still holding rawpy's 3: the blacks and gains are indexed by the
    channel, as in the JAX package."""
    rng = np.random.RandomState(5)
    frames = raw_stack(rng, (2, 6, 8))
    for cfa in ([[0, 1], [1, 0]], RAWPY_CFA["RGGB"]):
        args = (cfa, [64, 70, 80, 90], 4095, WB)
        np.testing.assert_array_equal(
            bits(native_loader.normalize_burst(frames, *args, device="cpu")),
            bits(j_nl.normalize_burst(frames, *args)))


def test_normalize_bayer_plain_is_numpy():
    """The plain K8 is a float32 subtract, then a multiply, per 2x2 phase
    slice: numpy's arithmetic bit for bit."""
    rng = np.random.RandomState(6)
    frames = raw_stack(rng, (2, 5, 7))
    black = np.asarray([300.5, 41.0, 65535.0], np.float32)
    gain = np.asarray([1 / 3, 1 / 959, 7.25], np.float32)
    cfa = [2, 1, 1, 0]
    want = np.empty(frames.shape, np.float32)
    for i in range(2):
        for j in range(2):
            c = cfa[2 * i + j]
            want[:, i::2, j::2] = (frames[:, i::2, j::2].astype(np.float32)
                                   - black[c]) * gain[c]
    got = cuda_ingest.normalize_bayer(torch.from_numpy(frames), cfa, black, gain)
    np.testing.assert_array_equal(bits(got), bits(want))
    with pytest.raises(ValueError):
        cuda_ingest.normalize_bayer(torch.from_numpy(frames.astype(np.int32)), cfa,
                                    black, gain)


UNPACK = {10: (j_nl.unpack_raw10, native_loader.unpack_raw10,
               cuda_ingest.unpack_raw10_plain),
          12: (j_nl.unpack_raw12, native_loader.unpack_raw12,
               cuda_ingest.unpack_raw12_plain)}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("fmt", list(UNPACK))
def test_unpack_against_jax(fmt, native, monkeypatch):
    """The plain K9 (both formats) and the native loader's unpackers, from
    numpy on the CPU and from a CPU tensor, bit for bit against the JAX
    package's C loader and numpy path, trailing bytes past the last group."""
    if native:
        jax_native()
    else:
        monkeypatch.setattr(j_nl, "_load", lambda: None)
    j_fn, fn, plain = UNPACK[fmt]
    per_group, group_bytes = cuda_ingest.RAW_FORMATS[fmt]
    for groups in (1, 7, 2003):
        n_pixels = per_group * groups
        packed = np.random.RandomState(groups).randint(
            0, 256, groups * group_bytes + 3).astype(np.uint8)
        want = j_fn(packed, n_pixels)
        for got in (plain(torch.from_numpy(packed), n_pixels),
                    fn(packed, n_pixels, device="cpu"),
                    fn(torch.from_numpy(packed), n_pixels)):
            assert got.dtype == torch.uint16 and tuple(got.shape) == (n_pixels,)
            np.testing.assert_array_equal(got.numpy(), want)
    assert cuda_ingest.unpack_raw.launches == 0


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback: asking for the card where there is none raises, in the
    normalizer, the unpackers (numpy input goes to the card by default) and
    the DNG load, and the library is not reported as present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = raw_stack(np.random.RandomState(7), (2, 4, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        native_loader.normalize_burst(frames, CFA["RGGB"], [64] * 4, 1023, WB)
    packed = np.zeros(10, np.uint8)
    for fn in (native_loader.unpack_raw10, native_loader.unpack_raw12):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(packed, 4)
    assert not native_loader.have_native()
    images = dng_folder(tmp_path, [frames[0], frames[1]])
    install_port(monkeypatch, images, BASE_TAGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        burst.load_dng_burst(tmp_path)


# ---------------------------------------------------------------------------
# the DNG loader of both packages on the same fakes
# ---------------------------------------------------------------------------

def dng_folder(path, frames):
    """Empty ``.dng`` placeholders a.dng, b.dng, ... (content comes from
    the fakes); ``{path: frame}``."""
    images = {}
    for i, frame in enumerate(frames):
        p = path / f"{chr(ord('a') + i)}.dng"
        p.write_bytes(b"")
        images[str(p)] = frame
    return images


def install_port(monkeypatch, images, tags, **raw_kw):
    """The fakes where the port imports them: ``sys.modules``."""
    monkeypatch.setitem(sys.modules, "rawpy", FakeRawpy(images, **raw_kw))
    monkeypatch.setitem(sys.modules, "exifread", FakeExifread(tags))


def install_both(monkeypatch, images, tags, **raw_kw):
    """The same fakes for the JAX package (its module attributes, as
    ``tests/test_dng_ingest.py`` installs them) and for the port."""
    monkeypatch.setattr(j_burst, "rawpy", FakeRawpy(images, **raw_kw))
    monkeypatch.setattr(j_burst, "exifread", FakeExifread(tags))
    monkeypatch.setattr(j_burst, "HAS_RAWPY", True)
    monkeypatch.setattr(j_burst, "HAS_EXIFREAD", True)
    install_port(monkeypatch, images, tags, **raw_kw)


def assert_bursts_equal(got, want):
    """Every field equal: frames bit for bit (tensors or numpy), metadata
    by value."""
    assert got._fields == want._fields
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if field in ("ref_raw", "comp_raws"):
            assert n(g).shape == w.shape and n(g).dtype == w.dtype, field
            np.testing.assert_array_equal(bits(g), bits(w))
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype, field
        else:
            assert type(g) is type(w) and g == w, field


def full_range_images(rng, count=2, h=8, w=8):
    return [raw_stack(rng, (h, w)) for _ in range(count)]


def low_images(rng, count=2, h=8, w=8):
    """tests/test_dng_ingest.py's frames: 64 to 1023."""
    return [rng.randint(64, 1024, (h, w)).astype(np.uint16) for _ in range(count)]


def _tags(**extra):
    tags = dict(BASE_TAGS)
    tags.update(extra)
    return tags


#: name -> (frames from a RandomState, tags, mode, fake raw's keywords)
DNG_CASES = {
    "exif_iso_preferred": (low_images, _tags(**{"Image ISOSpeedRatings": FakeTag(200)}),
                           "bayer", {}),
    "image_iso_fallback": (low_images, {"Image ISOSpeedRatings": FakeTag(400),
                                        "Image Orientation": FakeTag([1])}, "bayer", {}),
    "iso_clipped_high": (low_images, _tags(**{"EXIF ISOSpeedRatings": FakeTag(12800)}),
                         "bayer", {}),
    "iso_clipped_low": (low_images, _tags(**{"EXIF ISOSpeedRatings": FakeTag(50)}),
                        "bayer", {}),
    "orientation_read": (low_images, _tags(**{"Image Orientation": FakeTag([6])}),
                         "bayer", {}),
    "noise_profile_bayer": (low_images, _tags(**{"Image Tag 0xC761": FakeTag(
        [FakeRatio(12, 10), FakeRatio(3, 10), FakeRatio(18, 10), FakeRatio(6, 10),
         FakeRatio(24, 10), FakeRatio(9, 10)])}), "bayer", {}),
    "noise_profile_grey": (low_images, _tags(**{"Image Tag 0xC761": FakeTag(
        [FakeRatio(7), FakeRatio(2)])}), "grey", {}),
    "noise_profile_absent": (low_images, _tags(), "bayer", {}),
    "xyz2cam": (low_images, _tags(**{"Image Tag 0xC621": FakeTag(
        [FakeRatio(i + 1, 2) for i in range(9)])}), "bayer", {}),
    "normalization": (low_images, _tags(), "bayer",
                      dict(black=(64, 80, 96, 64), wb=(2.0, 1.0, 1.5, 1.0),
                           white_level=1023)),
    "three_frames_odd_shape": (lambda rng: low_images(rng, 3, 7, 9), _tags(), "bayer",
                               {}),
    **{f"cfa_{k}_full_range": (full_range_images, _tags(), "bayer",
                               dict(cfa=np.asarray(v), black=(2048, 1000, 3000, 1000),
                                    wb=(1.9, 1.0, 1.4, 1.0), white_level=65535))
       for k, v in RAWPY_CFA.items()},
}


@pytest.mark.parametrize("case", list(DNG_CASES))
def test_load_dng_burst_matches_jax(case, monkeypatch, tmp_path):
    """Each case of tests/test_dng_ingest.py, and every CFA layout over the
    full uint16 range, through both packages on the same fakes: every
    ``Burst`` field equal, frames bit for bit (the port's on the CPU)."""
    make, tags, mode, raw_kw = DNG_CASES[case]
    images = dng_folder(tmp_path, make(np.random.RandomState(len(case))))
    install_both(monkeypatch, images, tags, **raw_kw)
    want = j_burst.load_dng_burst(tmp_path, mode=mode)
    got = burst.load_dng_burst(tmp_path, mode=mode, device="cpu")
    assert isinstance(got.ref_raw, torch.Tensor) and isinstance(got.comp_raws,
                                                                torch.Tensor)
    assert_bursts_equal(got, want)
    assert cuda_ingest.normalize_bayer.launches == 0


def test_load_dng_burst_warnings_match_jax(monkeypatch, tmp_path):
    """A missing orientation tag warns in both (orientation 1); float frames
    warn in both and skip the normalization (numpy frames, as read)."""
    rng = np.random.RandomState(8)
    images = dng_folder(tmp_path, low_images(rng))
    install_both(monkeypatch, images, {"EXIF ISOSpeedRatings": FakeTag(100)})
    with pytest.warns(UserWarning, match="[Oo]rientation"):
        want = j_burst.load_dng_burst(tmp_path)
    with pytest.warns(UserWarning, match="[Oo]rientation"):
        got = burst.load_dng_burst(tmp_path, device="cpu")
    assert_bursts_equal(got, want)
    images = {k: rng.rand(8, 8).astype(np.float32) for k in images}
    install_both(monkeypatch, images, _tags())
    with pytest.warns(UserWarning, match="integer"):
        want = j_burst.load_dng_burst(tmp_path)
    with pytest.warns(UserWarning, match="integer"):
        got = burst.load_dng_burst(tmp_path, device="cpu")
    assert isinstance(got.ref_raw, np.ndarray)
    assert_bursts_equal(got, want)


def test_load_dng_burst_errors_match_jax(monkeypatch, tmp_path):
    """No ISO tag: ``AttributeError`` in both. Without rawpy/exifread: the
    same ``ImportError`` message."""
    images = dng_folder(tmp_path, low_images(np.random.RandomState(9)))
    install_both(monkeypatch, images, {"Image Orientation": FakeTag([1])})
    with pytest.raises(AttributeError) as want:
        j_burst.load_dng_burst(tmp_path)
    with pytest.raises(AttributeError) as got:
        burst.load_dng_burst(tmp_path, device="cpu")
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(j_burst, "HAS_RAWPY", False)
    monkeypatch.setitem(sys.modules, "rawpy", None)       # import rawpy fails
    with pytest.raises(ImportError, match="npz") as want:
        j_burst.load_dng_burst(tmp_path)
    with pytest.raises(ImportError) as got:
        burst.load_dng_burst(tmp_path, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the slice as a whole: process(<DNG folder>) in both packages
# ---------------------------------------------------------------------------

def _tune(c):
    """test_torch_process.py's: the default's finest two pyramid levels,
    SNR-based tile size and merge constants, x2, finishing off."""
    c.scale = 2
    c.verbose = 0
    c.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],
                                   search_radii=[1, 4], metrics=["L1", "L2"])
    c.postprocessing.enabled = False
    return c


def test_process_dng_folder_against_jax(monkeypatch, tmp_path):
    """``process`` on a folder of 4 fake 128x128 DNGs (a synthetic burst
    quantised to 10 bits over a black level of 64, non-unit white balance,
    ISO 100: the ISO-keyed noise curves) against the JAX package's
    ``process`` on the same folder, scan pipeline on both sides: the e2e
    bounds of tools/verify_e2e_parity.py on the interior."""
    from hmsr_tpu.configs import default_config as j_default_config
    from hmsr_tpu.io.synthetic import make_synthetic_burst
    from hmsr_tpu.models.process import process as j_process
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4, seed=11)
    black, white = 64, 1023
    frames = [np.round(f * (white - black) + black).astype(np.uint16)
              for f in (ref, *comps)]
    images = dng_folder(tmp_path, frames)
    install_both(monkeypatch, images, _tags(**{"EXIF ISOSpeedRatings": FakeTag(100)}),
                 black=(black,) * 4, wb=(1.9, 1.0, 1.4, 1.0), white_level=white)
    jc = _tune(j_default_config())
    jc.tpu.update(pipeline="scan", merge_impl="tiled", finishing_impl="device")
    pc = _tune(configs.default_config())
    pc["tpu"] = {"pipeline": "scan"}
    img_j, _ = j_process(str(tmp_path), jc)
    img_t, _ = P.process(str(tmp_path), pc, device="cpu")
    assert tuple(img_t.shape) == (256, 256, 3) == tuple(np.asarray(img_j).shape)
    d = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d.mean() < 1e-4 and d.max() < 1e-3
    assert pc.block_matching.tuning.tile_size == jc.block_matching.tuning.tile_size
    assert cuda_ingest.normalize_bayer.launches == 0


# ---------------------------------------------------------------------------
# tpu.correlation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["direct", "fft", "winograd"])
def test_correlation_switch_validated(value):
    """The port accepts what the JAX package accepts and refuses the rest
    (the JAX package asserts, the port raises ``ValueError``)."""
    from hmsr_tpu.configs import default_config as j_default_config
    from hmsr_tpu.configs import sanitize_config as j_sanitize
    from hmsr_tpu.configs import update_snr_config as j_update
    jc, pc = j_default_config(), configs.default_config()
    j_update(jc, 40)
    configs.update_snr_config(pc, 40)
    jc.tpu.correlation = value
    pc["tpu"] = {"correlation": value}
    if value == "winograd":
        with pytest.raises(AssertionError):
            j_sanitize(jc, (256, 256))
        with pytest.raises(ValueError, match="correlation"):
            configs.sanitize_config(pc, (256, 256))
    else:
        j_sanitize(jc, (256, 256))
        configs.sanitize_config(pc, (256, 256))


def _level_pair(seed, h, w):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4 + 4, w // 4 + 4).astype(np.float32)
    scene = np.kron(base, np.ones((4, 4), np.float32))
    ref = scene[4:4 + h, 4:4 + w] + 0.02 * rng.randn(h, w).astype(np.float32)
    dy, dx = rng.randint(-3, 4, 2)
    mov = scene[4 + dy:4 + dy + h, 4 + dx:4 + dx + w] \
        + 0.02 * rng.randn(h, w).astype(np.float32)
    return ref.astype(np.float32), mov.astype(np.float32), rng


@pytest.mark.parametrize("ts", [8, 16, 32])
def test_match_l2_equals_jax_fft(ts):
    """K1's L2 displacements (its plain version) equal the JAX package's
    ``match_l2`` with the FFT correlation on every tile of random levels."""
    for seed in range(4):
        ref, mov, rng = _level_pair(seed, 4 * ts, 5 * ts)
        tiles = ref.reshape(4, ts, 5, ts).transpose(0, 2, 1, 3)
        flow = rng.uniform(-3, 3, (4, 5, 2)).astype(np.float32)
        got = block_matching.match_l2(t(tiles), t(mov), t(flow), ts, 4)
        want = j_bm.match_l2(jnp.asarray(tiles), jnp.asarray(mov), jnp.asarray(flow),
                             ts, 4, backend="fft")
        np.testing.assert_array_equal(n(got), np.asarray(want))


def test_align_against_jax_fft():
    """The whole descent: the port's flows (``tpu.correlation: fft`` set on
    both sides) against the JAX package's ``align`` with its FFT
    correlation, within test_torch_alignment.py's 1e-4."""
    config = small_config(128, 16)
    config.tpu.correlation = "fft"
    ref, mov, _ = _level_pair(12, 128, 128)
    j_state = j_align.init_alignment(jnp.asarray(ref), config)
    want = j_align.align(j_state, jnp.asarray(mov), config)
    got = alignment.align(alignment.init_alignment(t(ref), config), t(mov), config)
    assert max_abs(got, want) <= 1e-4


def test_no_warning_on_integer_dng(monkeypatch, tmp_path):
    """An integer DNG burst with every tag loads without a warning."""
    images = dng_folder(tmp_path, low_images(np.random.RandomState(13)))
    install_port(monkeypatch, images, _tags())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        burst.load_dng_burst(tmp_path, device="cpu")
