#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hmsr_tpu_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing one result line (any failure raises: non-zero exit
and no final ``ok`` line):

0. require CUDA; print the card (``nvidia-smi`` name and power limit) and
   the torch / CUDA versions;
1. build the five kernels (K1 block matching, K2 ICA step, K3 fused ICA,
   K4 upscale-warp, K5 merge) from ``hmsr_tpu_torch/csrc`` and print the
   build seconds;
2. each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes (20x12 MP burst, x2, Ts=16; alignment
   levels also at Ts=32): max|d| and the median time of both (CUDA events);
3. the slice on the card against the slice on the CPU (512x512, 8 frames,
   default 4-level tuning, Ts=16): flow max|d| < 1e-2, image mean|d| < 1e-4
   and max|d| < 1e-3 on the interior;
4. the full main path: a 20-frame 3000x4000 Bayer burst made on the card
   from a seed, x2, warm-up + 3 timed runs; kernel launch counts of every
   run asserted against what the path implies; finite interior.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. The script imports neither
JAX nor the JAX package ``hmsr_tpu``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from hmsr_tpu_torch.models.alignment import (FUSED_GN_MAX_TILES, _level_tile_sizes,
                                             init_alignment)
from hmsr_tpu_torch.models.kernels import estimate_kernels
from hmsr_tpu_torch.models.pipeline import make_pipeline
from hmsr_tpu_torch.ops import _build, cuda_ica, cuda_merge, cuda_warp
from hmsr_tpu_torch.ops.grey import compute_grey_image
from hmsr_tpu_torch.ops.pyramid import build_gaussian_pyramid
from hmsr_tpu_torch.synthetic import (CFA_RGGB, WB, affine_curves, burst_config,
                                      burst_snr, make_burst)

KERNELS = {  # key: name, wrapper, source, TPU kernel it replaces
    "K1": ("K1 block matching", cuda_ica.block_match, "hmsr_tpu_torch/csrc/bm.cu",
           "hmsr_tpu/ops/pallas_ica.py:756"),
    "K2": ("K2 ICA Gauss-Newton step", cuda_ica.ica_step,
           "hmsr_tpu_torch/csrc/ica_step.cu", "hmsr_tpu/ops/pallas_ica.py:447"),
    "K3": ("K3 fused ICA (all Gauss-Newton steps, optional L1 search)",
           cuda_ica.ica_fused, "hmsr_tpu_torch/csrc/ica_fused.cu",
           "hmsr_tpu/ops/pallas_ica_fused.py:175"),
    "K4": ("K4 robustness upscale-warp", cuda_warp.upscale_warp,
           "hmsr_tpu_torch/csrc/warp.cu", "hmsr_tpu/ops/pallas_warp.py:279"),
    "K5": ("K5 merge accumulation", cuda_merge.merge_accumulate,
           "hmsr_tpu_torch/csrc/merge.cu", "hmsr_tpu/ops/pallas_merge.py:641"),
}


def log(*a):
    print(*a, flush=True)


def check_no_reference_imports():
    """The port runs without JAX and without the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hmsr_tpu"))
    if bad:
        raise AssertionError(f"modules of JAX or of hmsr_tpu were imported: {bad}")


def timed(fn, n=5):
    """Median milliseconds of ``fn()`` on the card (CUDA events, 1 warm-up)."""
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reset_counts():
    for _, fn, _, _ in KERNELS.values():
        fn.launches = 0


def counts():
    return {key: k[1].launches for key, k in KERNELS.items()}


def nan_max_abs(a, b):
    """max |a - b| over entries where both are finite; raises if the NaN
    patterns differ."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError("finite masks differ")
    return float((a[fa] - b[fa]).abs().max()) if fa.any() else 0.0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def blocky_scene(rng, h, w, block=8):
    base = rng.rand(h // block + 1, w // block + 1).astype(np.float32)
    return np.kron(base, np.ones((block, block), np.float32))[:h, :w]


def check_alignment_kernels(device, grey_shape, snr, rng, stats):
    """K1, K2 and K3 on every pyramid level of one configuration. Entries
    record whether the main path at this configuration launches the kernel
    on the level (K2 n_iter times)."""
    h, w = grey_shape
    config = burst_config(grey_shape, snr)
    n_iter = config.ica.tuning.n_iter
    scene = blocky_scene(rng, h + 8, w + 8)
    ref = scene[:h, :w] + 0.01 * rng.randn(h, w).astype(np.float32)
    mov = scene[3:h + 3, 5:w + 5] + 0.01 * rng.randn(h, w).astype(np.float32)
    state = init_alignment(torch.as_tensor(ref, device=device), config)
    mov_pyr = build_gaussian_pyramid(torch.as_tensor(mov, device=device),
                                     config.block_matching.tuning.factors)
    for l, (_, ts, radius, metric) in enumerate(_level_tile_sizes(config)):
        tiles, lvl, ica = state.tiles[l], state.pyramid[l], state.ica[l]
        mov_lvl = mov_pyr[l].contiguous()
        ny, nx = tiles.shape[:2]
        fused = ny * nx < FUSED_GN_MAX_TILES
        fused_bm = fused and metric == "L1" and radius == 1
        # integer, half-integer (round-half-even ties) and fractional flows
        fl = rng.uniform(-4, 4, (ny, nx, 2)).astype(np.float32)
        fl[::3] = np.round(fl[::3] * 2) / 2
        fl[0, 0] = (-60.0, 45.0)            # far outside the level
        flow = torch.as_tensor(fl, device=device)
        if metric == "L1":
            flow = torch.round(flow)
        key = f"ts{ts} r{radius} {metric} tiles {ny}x{nx}"

        d_k = cuda_ica.block_match(tiles, mov_lvl, flow, ts, radius, metric)
        d_p = cuda_ica.block_match_plain(tiles, mov_lvl, flow, ts, radius, metric)
        n_diff = int((d_k != d_p).sum())
        ms_k = timed(lambda: cuda_ica.block_match(tiles, mov_lvl, flow, ts,
                                                  radius, metric))
        ms_p = timed(lambda: cuda_ica.block_match_plain(tiles, mov_lvl, flow, ts,
                                                        radius, metric), n=3)
        log(f"  K1 {key}: displacements differing {n_diff}, "
            f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if n_diff:
            raise AssertionError(f"K1 {key}: {n_diff} displacements differ")
        stats["K1"].append(dict(err=0.0, ms=ms_k, plain_ms=ms_p, snr=snr,
                                per_frame=0 if fused_bm else 1))

        fl2 = flow + torch.as_tensor(rng.uniform(-0.99, 0.99, (ny, nx, 2)).astype(
            np.float32), device=device)
        b_k = cuda_ica.ica_step(lvl, ica.gradx, ica.grady, mov_lvl, fl2, ts)
        b_p = cuda_ica.ica_step_plain(lvl, ica.gradx, ica.grady, mov_lvl, fl2, ts)
        err = float((b_k - b_p).abs().max())
        rel = err / max(float(b_p.abs().max()), 1e-30)
        ms_k = timed(lambda: cuda_ica.ica_step(lvl, ica.gradx, ica.grady,
                                               mov_lvl, fl2, ts))
        ms_p = timed(lambda: cuda_ica.ica_step_plain(lvl, ica.gradx, ica.grady,
                                                     mov_lvl, fl2, ts))
        log(f"  K2 {key}: max|d| {err:.3e} (rel {rel:.3e}), "
            f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if not rel <= 1e-4:
            raise AssertionError(f"K2 {key}: relative error {rel:.3e} > 1e-4")
        stats["K2"].append(dict(err=err, ms=ms_k, plain_ms=ms_p, snr=snr,
                                per_frame=0 if fused else n_iter))

        # K3 as the level would run it (the L1 search only on L1 r=1 levels),
        # from fractional flows with half-integer ties
        bm = metric == "L1" and radius == 1
        fl3 = fl2.clone()
        fl3[1::3] = torch.round(fl3[1::3] * 2) / 2
        terms = cuda_ica.solve_terms(ica.hessian)
        args = (lvl, ica.gradx, ica.grady, terms, mov_lvl, fl3, ts, n_iter, bm)
        f_k = cuda_ica.ica_fused(*args)
        f_p = cuda_ica.ica_fused_plain(*args)
        err = float((f_k - f_p).abs().max())
        ms_k = timed(lambda: cuda_ica.ica_fused(*args))
        ms_p = timed(lambda: cuda_ica.ica_fused_plain(*args), n=3)
        log(f"  K3 {key}{' with L1 search' if bm else ''}: flow max|d| {err:.3e}, "
            f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
        if not err <= 1e-4:
            raise AssertionError(f"K3 {key}: flow max|d| {err:.3e} > 1e-4")
        stats["K3"].append(dict(err=err, ms=ms_k, plain_ms=ms_p, snr=snr,
                                per_frame=1 if fused else 0))


def check_warp_kernel(device, raw_shape, Ts, rng, stats):
    H, W = raw_shape
    lh, lw = H // 2, W // 2
    st = torch.as_tensor(rng.rand(3, lh, lw).astype(np.float32), device=device)
    fl = rng.uniform(-3, 3, (-(-H // Ts), -(-W // Ts), 2)).astype(np.float32)
    fl[0, :4] = (-40.0, 7.5)                # trips ok_tile at the border
    fl[-1, -4:] = (33.0, 41.0)
    flow = torch.as_tensor(fl, device=device)
    o_k, v_k = cuda_warp.upscale_warp(st, 2, Ts, flow, (H, W))
    o_p, v_p = cuda_warp.upscale_warp_plain(st, 2, Ts, flow, (H, W))
    err = nan_max_abs(o_k, o_p)
    n_mask = int((v_k != v_p).sum())
    ms_k = timed(lambda: cuda_warp.upscale_warp(st, 2, Ts, flow, (H, W)))
    ms_p = timed(lambda: cuda_warp.upscale_warp_plain(st, 2, Ts, flow, (H, W)))
    log(f"  K4 stats {(3, lh, lw)} -> {(3, H, W)}: max|d| {err:.3e}, valid "
        f"masks differing {n_mask} (invalid pixels {int((~v_p).sum())}), "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    if not (err <= 1e-5 and n_mask == 0):
        raise AssertionError(f"K4: max|d| {err:.3e}, {n_mask} mask differences")
    stats["K4"].append(dict(err=err, ms=ms_k, plain_ms=ms_p, snr=None, per_frame=1))


def check_merge_kernel(device, raw_shape, Ts, rng, stats):
    H, W = raw_shape
    config = burst_config(raw_shape, 40)
    comp = torch.as_tensor(np.clip(blocky_scene(rng, H, W, 4)
                                   + 0.02 * rng.randn(H, W), 0, 1).astype(np.float32),
                           device=device)
    covs = estimate_kernels(comp, config).contiguous()
    fl = rng.uniform(-3, 3, (-(-H // Ts), -(-W // Ts), 2)).astype(np.float32)
    fl[0, :4] = (-40.0, 7.5)
    fl[-1, -4:] = (33.0, 41.0)
    flow = torch.as_tensor(fl, device=device)
    r = torch.as_tensor(rng.rand(H, W).astype(np.float32), device=device)
    base_n = torch.as_tensor(rng.rand(3, 2 * H, 2 * W).astype(np.float32), device=device)
    base_d = torch.as_tensor(rng.rand(3, 2 * H, 2 * W).astype(np.float32), device=device)
    n_k, d_k = base_n.clone(), base_d.clone()
    n_p, d_p = base_n.clone(), base_d.clone()
    cuda_merge.merge_accumulate(comp, flow, covs, r, n_k, d_k, CFA_RGGB, Ts, 2)
    cuda_merge.merge_plain(comp, flow, covs, r, n_p, d_p, CFA_RGGB, Ts, 2)
    abs_n, abs_d = nan_max_abs(n_k, n_p), nan_max_abs(d_k, d_p)
    err_n = abs_n / float(n_p.abs().max())
    err_d = abs_d / float(d_p.abs().max())
    ms_k = timed(lambda: cuda_merge.merge_accumulate(comp, flow, covs, r, n_k, d_k,
                                                     CFA_RGGB, Ts, 2))
    ms_p = timed(lambda: cuda_merge.merge_plain(comp, flow, covs, r, n_p, d_p,
                                                CFA_RGGB, Ts, 2), n=3)
    log(f"  K5 comp {(H, W)} -> num/den {(3, 2 * H, 2 * W)}: rel max|d| num "
        f"{err_n:.3e} den {err_d:.3e}, kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    if not (err_n <= 1e-5 and err_d <= 1e-5):
        raise AssertionError(f"K5: relative errors {err_n:.3e} / {err_d:.3e}")
    stats["K5"].append(dict(err=max(abs_n, abs_d), ms=ms_k, plain_ms=ms_p, snr=None,
                            per_frame=1))


def phase_kernels(device, grey_shape, seed=1):
    """Phase 2. Returns per-kernel lists of dicts: max_abs_err ``err``,
    ``ms``, ``plain_ms``, ``snr`` (None where the tile size does not matter)
    and ``per_frame``, the launches per frame of the main path at that SNR."""
    rng = np.random.RandomState(seed)
    stats = {key: [] for key in KERNELS}
    check_alignment_kernels(device, grey_shape, 40, rng, stats)   # Ts 16 (8)
    check_alignment_kernels(device, grey_shape, 18, rng, stats)   # Ts 32 (16)
    check_warp_kernel(device, grey_shape, 16, rng, stats)
    check_merge_kernel(device, grey_shape, 16, rng, stats)
    return stats


# ---------------------------------------------------------------------------
# phase 3: the slice on the card against the slice on the CPU
# ---------------------------------------------------------------------------

def phase_slice(device, size=512, n_frames=8, seed=2):
    frames = make_burst(size, size, n_frames, seed, device)
    std, diff = affine_curves()
    config = burst_config((size, size), 40, debug=True)
    outs = {}
    for dev in (device, "cpu"):
        burst = frames.to(dev)
        img, dbg = make_pipeline(config, CFA_RGGB, WB, dev)(burst[0], burst[1:],
                                                             std, diff)
        outs[dev] = (img.cpu(), dbg["flow"].cpu())
    (img_g, flow_g), (img_c, flow_c) = outs[device], outs["cpu"]
    d_flow = float((flow_g - flow_c).abs().max())
    d_img = (img_g - img_c).abs()[8:-8, 8:-8]
    res = dict(flow_max=d_flow, img_mean=float(d_img.mean()), img_max=float(d_img.max()))
    log(f"phase 3 slice {size}x{size} x{n_frames} Ts="
        f"{config.block_matching.tuning.tile_size}, card vs CPU: flow max|d| "
        f"{res['flow_max']:.3e}, image mean|d| {res['img_mean']:.3e}, "
        f"max|d| {res['img_max']:.3e}")
    if not (d_flow < 1e-2 and res["img_mean"] < 1e-4 and res["img_max"] < 1e-3):
        raise AssertionError(f"slice parity failed: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 4: the full main path
# ---------------------------------------------------------------------------

def expected_launches(ref, config, n_cmp):
    """Launches per burst of each kernel that the path implies: per
    compared frame and level, K1 then n_iter K2 steps, or K3 on levels under
    FUSED_GN_MAX_TILES tiles (with its own L1 search on L1 radius-1 levels,
    else after K1); one K4 and one K5 per frame, and two K4 at init."""
    n_iter = config.ica.tuning.n_iter
    state = init_alignment(compute_grey_image(ref, "FFT"), config)
    k1 = k2 = k3 = 0
    for tiles, (_, _, radius, metric) in zip(state.tiles, _level_tile_sizes(config)):
        if tiles.shape[0] * tiles.shape[1] < FUSED_GN_MAX_TILES:
            k3 += 1
            k1 += 0 if (metric == "L1" and radius == 1) else 1
        else:
            k1 += 1
            k2 += n_iter
    return {"K1": n_cmp * k1, "K2": n_cmp * k2, "K3": n_cmp * k3,
            "K4": n_cmp + 2, "K5": n_cmp}


def phase_full(device, h=3000, w=4000, n_frames=20, n_runs=3, seed=0):
    t0 = time.perf_counter()
    frames = make_burst(h, w, n_frames, seed, device)
    std, diff = affine_curves()
    snr = burst_snr(frames[0], std)
    config = burst_config((h, w), snr)
    torch.cuda.synchronize()
    log(f"phase 4 burst {n_frames}x{h}x{w} made on the card in "
        f"{time.perf_counter() - t0:.2f} s; SNR {snr:.1f} -> Ts="
        f"{config.block_matching.tuning.tile_size}, scale {config.scale}")
    ref, comps = frames[0], frames[1:]
    pipe = make_pipeline(config, CFA_RGGB, WB, device)
    std_t = torch.as_tensor(std, device=device)
    diff_t = torch.as_tensor(diff, device=device)

    expect = expected_launches(ref, config, n_frames - 1)
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for i in range(n_runs + 1):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        image, _ = pipe(ref, comps, std_t, diff_t)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        if got != expect or not all(got.values()):
            raise AssertionError(f"kernel launch counts {got}, expected {expect}")
        launches = got
        sub = image[::31, ::37]
        checksum = float(torch.where(torch.isfinite(sub), sub,
                                     torch.zeros((), device=device)).sum())
        log(f"  run {i} ({'warm-up' if i == 0 else 'timed'}): {dt:.4f} s, "
            f"checksum {checksum:.6f}")
        if i:
            times.append(dt)
    if tuple(image.shape) != (2 * h, 2 * w, 3):
        raise AssertionError(f"image shape {tuple(image.shape)}")
    if not bool(torch.isfinite(image[8:-8, 8:-8]).all()):
        raise AssertionError("non-finite values in the image interior")
    peak = torch.cuda.max_memory_allocated()
    res = dict(min_s=min(times), median_s=statistics.median(times),
               peak_bytes=peak, launches=launches, checksum=checksum)
    log(f"phase 4 {n_frames}x{h}x{w} x{config.scale}: min {res['min_s']:.4f} s, "
        f"median {res['median_s']:.4f} s of {n_runs}; peak memory "
        f"{peak / 2**30:.3f} GiB; launches per run {launches}; interior finite")
    return res


def main():
    check_no_reference_imports()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    device = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase 0 torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.library()
    log(f"phase 1 built {len(KERNELS)} kernels in {_build.build_seconds:.2f} s")

    log("phase 2 kernels against their plain versions (main-path shapes)")
    stats = phase_kernels(device, (3000, 4000))
    phase_slice(device)
    phase_full(device)

    entries = []
    for key, (name, fn, src, rep) in KERNELS.items():
        # time per frame of the main path's launches (the Ts=16 set)
        main_path = [e for e in stats[key] if e["snr"] in (40, None)]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": fn.launches,
            "max_abs_err": max(e["err"] for e in stats[key]),
            "ms": sum(e["per_frame"] * e["ms"] for e in main_path),
            "plain_ms": sum(e["per_frame"] * e["plain_ms"] for e in main_path)})
    check_no_reference_imports()
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
