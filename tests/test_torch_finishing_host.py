"""The port's host finishing chain (``finishing/raw2rgb.py``) and the
finishing routes of ``process_burst`` against the JAX package, on the CPU.

The chain is numpy/scipy/OpenCV on both sides, so each switch is held at
max|d| <= 1e-6. ``process_arrays`` runs in every route of
``tpu.finishing_impl`` against JAX ``process_arrays`` on its scan pipeline,
with ``tools/verify_e2e_parity.py``'s image bounds (mean|d| < 1e-4, max|d| <
1e-3) on the finished image before quantisation; in the Mertens route, whose
fusion quantises its inputs to 8 bits, under 0.1 % of the values may exceed
1e-3, each by less than 2/255. The routes and the chain that need cv2 run
where it imports; the no-cv2 branches are pinned by failing its import.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import block_imports, n  # noqa: E402

from hmsr_tpu.finishing import raw2rgb as j_raw2rgb  # noqa: E402
from hmsr_tpu.io.synthetic import make_synthetic_burst  # noqa: E402
from hmsr_tpu.models.process import process_arrays as j_process_arrays  # noqa: E402
from hmsr_tpu_torch import configs  # noqa: E402
from hmsr_tpu_torch.finishing import raw2rgb  # noqa: E402
from hmsr_tpu_torch.models import process as P  # noqa: E402

SHARPEN = {"enabled": True, "amount": 1.5, "radius": 3}
XYZ2CAM = np.array([[1.2, -0.1, 0.0], [-0.2, 1.1, 0.1], [0.0, 0.2, 0.9]])
SIZE = 64


def _image(seed=7, h=65, w=47):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, 3) * 1.2 - 0.1).astype(np.float32)


SWITCHES = {
    "ccm-eye": dict(do_color_correction=True, do_tonemapping=False, do_gamma=True),
    "ccm-xyz2cam": dict(do_color_correction=True, do_tonemapping=False, do_gamma=True,
                        xyz2cam=XYZ2CAM),
    "sharpening": dict(do_color_correction=False, do_tonemapping=False, do_gamma=True,
                       sharpening_config=SHARPEN),
    "devignette": dict(do_color_correction=False, do_tonemapping=False, do_gamma=False,
                       do_devignette=True),
    "mertens": dict(do_color_correction=False, do_tonemapping=True, do_gamma=True),
    "no-cv2-smoothstep": dict(do_color_correction=False, do_tonemapping=True,
                              do_gamma=True),
    "gamma-only": dict(do_color_correction=False, do_tonemapping=False, do_gamma=True),
    "linear": dict(do_color_correction=False, do_tonemapping=False, do_gamma=False),
    "all": dict(do_color_correction=True, do_tonemapping=True, do_gamma=True,
                sharpening_config=SHARPEN, do_devignette=True, xyz2cam=XYZ2CAM),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_postprocess_against_jax(switch, monkeypatch):
    """Each switch of the chain alone (and all together) within 1e-6; the
    Mertens fusion with cv2, the plain smoothstep and its warning without."""
    kw = SWITCHES[switch]
    img = _image()
    if switch == "no-cv2-smoothstep":
        block_imports(monkeypatch, "cv2")
        with pytest.warns(UserWarning):
            want = j_raw2rgb.postprocess(img, **kw)
        with pytest.warns(UserWarning):
            got = raw2rgb.postprocess(img, **kw)
    else:
        want = j_raw2rgb.postprocess(img, **kw)
        got = raw2rgb.postprocess(img, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_apply_ccm_refuses_other_shapes():
    with pytest.raises(ValueError):
        raw2rgb.apply_ccm(np.zeros((4, 4, 4), np.float32), np.eye(3))


def _tune(c, impl, tonemap):
    c.scale = 2
    c.verbose = 0
    c.block_matching.tuning.update(factors=[1, 2], tile_size_factors=[1, 1],
                                   search_radii=[1, 4], metrics=["L1", "L2"])
    c.postprocessing.do_tonemapping = tonemap
    c["tpu"] = dict(c.get("tpu", {}), finishing_impl=impl)
    return c


#: route id -> (tpu.finishing_impl, do_tonemapping, cv2 importable, the
#: port's chain is the device's)
ROUTES = {"device": ("device", False, True, True),
          "host": ("host", False, True, False),
          "auto": ("auto", False, True, True),
          "auto-tonemap-cv2": ("auto", True, True, False),
          "auto-tonemap-no-cv2": ("auto", True, False, True),
          "host-tonemap-no-cv2": ("host", True, False, False)}


@pytest.fixture(scope="module")
def burst():
    ref, comps, _, _ = make_synthetic_burst(SIZE, SIZE, n_frames=4, seed=3)
    return ref, comps


@pytest.mark.parametrize("route", list(ROUTES))
def test_process_routes_against_jax(burst, route, monkeypatch):
    """``process_arrays`` (ISO-keyed curves, sharpening + gamma, tonemapping
    as the route says) in each finishing route against the JAX package on
    its scan pipeline: the route the port picks is the JAX package's, and the
    float32 image agrees within the e2e bounds on the interior. The host
    chain's image comes back to the device as float32."""
    from hmsr_tpu.configs import default_config
    impl, tonemap, cv2_ok, on_device = ROUTES[route]
    if cv2_ok:
        pytest.importorskip("cv2")
    else:
        block_imports(monkeypatch, "cv2")
    ref, comps = burst
    jc = _tune(default_config(), impl, tonemap)
    jc.tpu.update(pipeline="scan", merge_impl="tiled")
    pc = _tune(configs.default_config(), impl, tonemap)
    pc.tpu.pipeline = "scan"
    assert P.use_device_finishing(pc) == on_device
    img_j, _ = j_process_arrays(ref, comps, jc, iso=100)
    img_t, _ = P.process_arrays(ref, comps, pc, iso=100, device="cpu")
    assert img_t.dtype == torch.float32 and isinstance(img_t, torch.Tensor)
    assert tuple(img_t.shape) == (2 * SIZE, 2 * SIZE, 3)
    d = np.abs(n(img_t) - np.asarray(img_j))[8:-8, 8:-8]
    assert d.mean() < 1e-4, d.mean()
    if route == "auto-tonemap-cv2":
        # the Mertens fusion takes its three exposures as 8-bit images: where
        # a linear value lies within the pipelines' difference (< 1e-5) of a
        # step, one side rounds it one step (1/255) further, and the fused
        # pixel moves by up to that step
        assert (d >= 1e-3).mean() < 1e-3 and d.max() < 2 / 255, d.max()
    else:
        assert d.max() < 1e-3, d.max()
