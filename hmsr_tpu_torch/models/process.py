"""Public API: ``process``, ``process_arrays``, ``process_burst`` (twin of
:mod:`hmsr_tpu.models.process`).

The steps, in the order of the JAX package: the noise model (the user's
alpha/beta > the burst's noise profile > ISO-keyed curves from the repo's
``data/``), the Monte-Carlo noise curves when none were loaded, the SNR and
the SNR-adaptive configuration, the pipeline (:mod:`.pipeline`), the device
finishing chain, and the EXIF orientation of the image and of the
accumulated robustness.

Everything runs on one ``device``, the card unless the caller asks for the
CPU: the burst is moved there once, and the image and the debug tensors
are returned there. The image is (round(s H), round(s W), 3) with the
finishing on, and has c channels without it (c = 1 in grey mode). The
median or Gauss frame-count denoiser
(``accumulated_robustness_denoiser.median`` / ``.gauss``) runs on the
device after the pipeline, before the finishing. The finishing takes the
JAX package's route (:func:`use_device_finishing`): the device chain, or the
host chain (:mod:`..finishing.raw2rgb`, OpenCV's Mertens fusion), whose
result comes back to ``device`` as float32.

A mesh (``tpu.mesh = [nf, ns]``, ``nf * ns > 1``) takes the sharded
pipeline (:mod:`hmsr_tpu_torch.parallel`): every rank of a
``torch.distributed`` process group of ``nf * ns`` ranks calls
``process_burst`` with the same burst (``torchrun --nproc-per-node=N``);
the frames are padded with zero-weight frames to a multiple of ``nf``, the
Monte-Carlo noise curves are drawn on rank 0 and broadcast, and every rank
finishes the same assembled image. Without such a process group it raises
``RuntimeError`` before any work.
"""

import os
import time

import numpy as np
import torch

from ..configs import default_config, sanitize_config, update_snr_config
from ..finishing import apply_orientation, make_postprocess_device, postprocess
from ..finishing.denoise import frame_count_denoising_gauss, frame_count_denoising_median
from ..io.burst import Burst, load_burst
from ..noise import fit_alpha_beta, load_noise_curves, run_fast_MC
from ..noise.fast_monte_carlo import N_BRIGHTNESS_LEVELS
from ..parallel import make_mesh, make_sharded_pipeline, pad_frames
from ..utils.timing import getTime, timer
from ..utils.types import DEFAULT_FLOAT, resolve_device
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .pipeline import accum_shape, make_pipeline, select_merge, to_grey, to_raw_flow
from .robustness import compute_robustness, init_robustness

#: the repo's ``data/`` directory of ISO-keyed noise curves.
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def process(burst_path, config=None, device="cuda"):
    """Process a raw burst folder / bundle into an RGB image; returns
    ``(image, debug)`` on ``device``. A DNG folder's frames are normalized
    there (K8 on the card)."""
    if config is None:
        config = default_config()
    burst = timer(load_burst, config.verbose >= 2, end_s=" -- Load burst")(
        burst_path, mode=config.mode, device=device)
    return process_burst(burst, config, device)


def process_arrays(ref_raw, comp_raws, config=None, cfa=None,
                   white_balance=None, xyz2cam=None, orientation=1, iso=100,
                   device="cuda"):
    """Process an already-loaded burst: ``ref_raw`` (H, W) and ``comp_raws``
    (N-1, H, W), numpy arrays or tensors, moved to ``device`` as float32
    once."""
    if config is None:
        config = default_config()
    if cfa is None:
        cfa = np.array([[0, 1], [1, 2]])
    if white_balance is None:
        white_balance = [1.0, 1.0, 1.0]
    burst = Burst(ref_raw=ref_raw, comp_raws=comp_raws,
                  iso=iso, cfa=np.asarray(cfa), xyz2cam=xyz2cam,
                  white_balance=list(white_balance), noise_alpha=None,
                  noise_beta=None, orientation=orientation, ref_path=None)
    return process_burst(burst, config, device)


def mesh_of(config):
    """The rank's :class:`~hmsr_tpu_torch.parallel.Mesh` when ``tpu.mesh``
    asks for several ranks, else None; raises ``RuntimeError`` outside a
    process group of that size."""
    shape = config.get("tpu", {}).get("mesh", None)
    if shape and int(shape[0]) * int(shape[1]) > 1:
        return make_mesh(int(shape[0]), int(shape[1]))
    return None


def broadcast_mc_curves(alpha, beta, device):
    """The Monte-Carlo noise curves drawn on rank 0 of the default process
    group and broadcast, so that every rank merges with the same bits (and
    one rank writes the disk cache)."""
    import torch.distributed as dist
    buf = torch.empty((2, N_BRIGHTNESS_LEVELS + 1), dtype=torch.float64, device=device)
    if dist.get_rank() == 0:
        buf.copy_(torch.as_tensor(np.stack(run_fast_MC(alpha, beta, device=device))))
    dist.broadcast(buf, src=0)
    std, diff = buf.cpu().numpy()
    return std, diff


def use_device_finishing(config):
    """The JAX package's finishing route: ``tpu.finishing_impl`` "device"
    takes the device chain, "auto" takes it unless tonemapping is on and cv2
    imports (the Mertens fusion is OpenCV's, on the host), and anything else
    ("host") takes the host chain."""
    impl = config.get("tpu", {}).get("finishing_impl", "auto")
    needs_mertens = False
    if config.postprocessing.do_tonemapping and impl != "device":
        try:
            import cv2  # noqa: F401
            needs_mertens = True
        except ImportError:
            pass
    return impl == "device" or (impl == "auto" and not needs_mertens)


def _trace_stages(burst, std_curve, diff_curve, config, device):
    """verbose >= 3: per-stage times on the first compared frame, each stage
    run on its own and ended by a synchronise (relative weights, not a
    budget)."""
    def sync(x):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return x

    ref, frame = burst.ref_raw, burst.comp_raws[0]
    curves = (torch.as_tensor(std_curve, dtype=DEFAULT_FLOAT, device=device),
              torch.as_tensor(diff_curve, dtype=DEFAULT_FLOAT, device=device))
    cfa, wb = burst.cfa, burst.white_balance
    print(" -- Stage trace (first frame):")
    t0 = time.perf_counter()
    astate = sync(init_alignment(to_grey(ref, config), config))
    rstats = sync(init_robustness(ref, cfa, wb, curves, config))
    t0 = getTime(t0, " --- Ref init (grey+pyramid+stats)")
    grey = sync(to_grey(frame, config))
    t0 = getTime(t0, " --- Grey conversion")
    flow = sync(to_raw_flow(align(astate, grey, config), frame.shape, config))
    t0 = getTime(t0, " --- Alignment (BM + ICA)")
    r = sync(compute_robustness(frame, rstats, flow, cfa, wb, config))
    t0 = getTime(t0, " --- Robustness")
    covs = sync(estimate_kernels(frame, config))
    t0 = getTime(t0, " --- Kernel estimation")
    num = torch.zeros(accum_shape(config, frame.shape), dtype=DEFAULT_FLOAT,
                      device=device)
    den = torch.zeros_like(num)
    sync(select_merge(config)(frame, flow, covs, r, num, den, cfa, config))
    getTime(t0, " --- Merge (one frame)")


def _try_iso_curves(burst, config):
    """ISO-keyed curves from ``config.noise_model.data_dir`` or the repo's
    ``data/`` (:data:`DATA_DIR`); ``(None, None)`` when there are none.
    (The JAX package also looks in ``./data`` of the working directory; the
    port reads nothing outside its checkout unless told to.)"""
    if burst.iso is None:
        return None, None
    for d in (config.noise_model.get("data_dir", None), DATA_DIR):
        if not d:
            continue
        try:
            std, diff = load_noise_curves(burst.iso, d)
        except (OSError, ValueError):
            continue
        return np.asarray(std, np.float32), np.asarray(diff, np.float32)
    return None, None


def process_burst(burst, config, device="cuda"):
    """Returns ``(image, debug)`` on ``device``, the image (round(s H),
    round(s W), 3) with the finishing on; ``config`` is resolved in place
    (noise model, SNR-based entries), as in the JAX package."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    mesh = mesh_of(config)
    verbose_1 = config.verbose >= 1
    verbose_2 = config.verbose >= 2
    ref = torch.as_tensor(burst.ref_raw, dtype=DEFAULT_FLOAT, device=device)
    comps = torch.as_tensor(burst.comp_raws, dtype=DEFAULT_FLOAT, device=device)
    burst = burst._replace(ref_raw=ref, comp_raws=comps)

    # ---- noise model: user-provided > burst noise profile > ISO-keyed curves
    std_curve = diff_curve = None
    if config.noise_model.get("alpha", None) is not None:
        if verbose_1:
            print("Using user provided alpha and beta values")
        alpha, beta = config.noise_model.alpha, config.noise_model.beta
    elif burst.noise_alpha is not None:
        alpha, beta = burst.noise_alpha, burst.noise_beta
    else:
        std_curve, diff_curve = _try_iso_curves(burst, config)
        if std_curve is None:
            raise ValueError(
                "No noise model available: provide noise_model.alpha/beta in "
                "the config, use bundles carrying a noise profile, or ship "
                "ISO-keyed curves (noise_model.data_dir).")
        if verbose_1:
            print(f"Using ISO-keyed noise curves (ISO {burst.iso})")
        alpha, beta = fit_alpha_beta(std_curve)
    config.noise_model.update({"alpha": float(alpha), "beta": float(beta)})

    # ---- Monte-Carlo noise curves on the device (cached per alpha/beta)
    if std_curve is None:
        std_curve, diff_curve = run_fast_MC(alpha, beta, device=device) \
            if mesh is None else broadcast_mc_curves(alpha, beta, device)
    if verbose_2:
        t0 = getTime(t0, " -- Read raw files & noise curves")

    # ---- SNR-adaptive hyperparameters
    brightness = float(torch.mean(ref, dtype=torch.float64))
    id_noise = int(round(1000 * brightness))
    std = std_curve[np.clip(id_noise, 0, len(std_curve) - 1)]
    snr = brightness / std
    if verbose_1:
        print(" ", 10 * "-")
        print(f"|ISO : {burst.iso}")
        print(f"|Image brightness : {brightness:.2f}")
        print(f"|expected noise std : {std:.2e}")
        print(f"|Estimated SNR : {snr:.2f}")
    update_snr_config(config, snr)
    sanitize_config(config, tuple(ref.shape))
    ard = config.accumulated_robustness_denoiser
    ard.enabled = bool(ard.median.enabled or ard.gauss.enabled or ard.merge.enabled)

    # ---- the pipeline (sharded over the ranks with a mesh), optionally under
    # torch.profiler
    curves = (torch.as_tensor(std_curve, dtype=DEFAULT_FLOAT, device=device),
              torch.as_tensor(diff_curve, dtype=DEFAULT_FLOAT, device=device))
    if mesh is None:
        if config.verbose >= 3:
            _trace_stages(burst, std_curve, diff_curve, config, device)
        pipe = make_pipeline(config, burst.cfa, burst.white_balance, device)

        def run():
            return pipe(ref, comps, *curves)
    else:
        sharded = make_sharded_pipeline(config, burst.cfa, burst.white_balance, mesh,
                                        device)
        frames, weights = pad_frames(comps, mesh.n_frames)

        def run():
            outs = sharded(ref, frames, weights, *curves)
            debug = {}
            if ard.enabled or config.robustness.save_mask:
                debug["accumulated_robustness"] = outs[1]
            if config.debug:            # without the zero-weight padding frames
                debug["flow"] = outs[2][:len(comps)]
                debug["robustness"] = outs[3][:len(comps)]
            return outs[0], debug
    run = timer(run, verbose_2, end_s=" -- Device pipeline (align+merge)")
    profile_dir = config.get("tpu", {}).get("profile_dir", None)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            image, debug = run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "pipeline_trace.json"))
    else:
        image, debug = run()

    # ---- frame-count-aware post denoising, with the pipeline's scale
    if ard.median.enabled or ard.gauss.enabled:
        if verbose_1:
            print("-- Robustness aware bluring")
        t_dn = time.perf_counter()
        acc_r = debug["accumulated_robustness"]
        for cfg, fn in ((ard.median, frame_count_denoising_median),
                        (ard.gauss, frame_count_denoising_gauss)):
            if cfg.enabled:
                dc = cfg.copy()
                dc["scale"] = config.scale
                image = fn(image, acc_r, dc)
        if verbose_2:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            getTime(t_dn, " -- Frame-count denoising")

    # ---- finishing: the device chain, or the host chain and back
    pp = config.postprocessing
    if pp.enabled:
        on_device = use_device_finishing(config)
        if verbose_2:
            print(f"-- Post processing image ({'device' if on_device else 'host'})")
        kw = dict(do_color_correction=pp.do_color_correction,
                  do_tonemapping=pp.do_tonemapping, do_gamma=pp.do_gamma_correction,
                  sharpening_config=pp.sharpening, do_devignette=pp.do_devignetting,
                  xyz2cam=burst.xyz2cam)
        if on_device:
            fin = make_postprocess_device(**kw)
        else:
            def fin(rgb):
                out = postprocess(rgb.cpu().numpy(), **kw)
                return torch.as_tensor(out, dtype=DEFAULT_FLOAT, device=device)
        rgb = image.expand(-1, -1, 3) if image.shape[-1] == 1 else image
        image = timer(fin, verbose_2, end_s=" -- Finishing ISP")(rgb)

    image = apply_orientation(image, burst.orientation)
    if "accumulated_robustness" in debug:
        debug["accumulated_robustness"] = apply_orientation(
            debug["accumulated_robustness"], burst.orientation)

    if verbose_1:
        s = "\nTotal ellapsed time : "
        print(s, " " * (50 - len(s)), ": ", round(time.perf_counter() - t0, 2),
              "seconds")
    return image, debug
