"""Accuracy of the port against ground truth, on the card by default.

Run from the root of a checkout::

    python3 -m hmsr_tpu_torch.score_accuracy [--device cuda] [--pipeline scan]
        [--out accuracy.json]

The truth and robustness-value sections of the JAX package's
``tools/score_accuracy.py``, with the port's pipeline
(:func:`hmsr_tpu_torch.models.pipeline.make_pipeline`, ``tpu.pipeline``
``--pipeline``: scan by default; ``fused`` is the form the JAX tool runs on
the CPU, through which ``ACCURACY_r05.json`` was scored) on the bursts
of :mod:`hmsr_tpu_torch.io.synthetic` (the same bursts as the JAX package's,
bit for bit):

1. ``psnr_vs_truth_db``: the x2 output of a 20-frame 512x512 burst (seed 7)
   against the scene it was rendered from, with 2 Ts HR pixels cropped all
   around (the borders carry no multi-frame data);
2. ``robustness_value``: the x2 output of a 12-frame 384x384 burst with a
   disc moving across it (seed 21), with robustness on and off, scored on
   the region the disc covers in any frame (ghost) and everywhere
   (global), with the same crop.

The configuration is ``bench.py``'s at the bright tier (SNR 56: Ts=16), the
accumulated-robustness denoiser off. The JAX section against the composed
float64 oracle (``tests/oracles/``) is not here. Prints one line per score
and, last, the result as one JSON object; writes it to ``--out`` if given.
"""

import argparse
import json
import os
import time

import numpy as np

from .io.synthetic import DEFAULT_CFA, make_occlusion_burst, make_synthetic_burst
from .models.pipeline import make_pipeline
from .synthetic import ALPHA, BETA, WB, affine_curves, burst_config
from .utils.metrics import compute_psnr
from .utils.types import resolve_device

TRUTH_SIZE, TRUTH_FRAMES = 512, 20           # section 1's burst
OCCLUSION_SIZE, OCCLUSION_FRAMES = 384, 12   # section 2's burst
SNR = 56.0                                   # the bright tier: Ts=16


def build_config(h, w, pipeline="scan"):
    """x2 Bayer, the denoiser off, the SNR-based entries resolved at the
    bright tier (``tools/score_accuracy.py``'s configuration), the
    ``tpu.pipeline`` form ``pipeline``."""
    c = burst_config((h, w), SNR)
    c["tpu"] = {"pipeline": pipeline}
    return c


def run_pipeline(ref, comps, config, device):
    """The port's pipeline on ``device``; the image as a numpy array with
    NaNs set to 0. (The noise curves are ``tools/score_accuracy.py``'s:
    its formula regroups ``affine_curves``' and gives the same float32
    bits.)"""
    std, diff = affine_curves()
    img, _ = make_pipeline(config, DEFAULT_CFA, WB, device)(ref, comps, std, diff)
    return np.nan_to_num(img.cpu().numpy(), nan=0.0)


def score_truth(size=TRUTH_SIZE, frames=TRUTH_FRAMES, device="cuda", seed=7,
                pipeline="scan"):
    """Section 1: ``{"size", "frames", "crop_px", "psnr_db", "seconds"}``
    (``seconds``: the pipeline call, synchronised by the read-back), through
    the ``pipeline`` form."""
    ref, comps, truth, _ = make_synthetic_burst(size, size, n_frames=frames, alpha=ALPHA,
                                                beta=BETA, seed=seed, max_shift=2.0)
    config = build_config(size, size, pipeline)
    t0 = time.perf_counter()
    img = run_pipeline(ref, comps, config, device)
    dt = time.perf_counter() - t0
    crop = 2 * int(config.block_matching.tuning.tile_size)
    inner = np.s_[crop:-crop, crop:-crop]
    return {"size": [size, size], "frames": frames, "crop_px": crop,
            "psnr_db": compute_psnr(img[inner], truth[inner]), "seconds": dt}


def score_robustness(size=OCCLUSION_SIZE, frames=OCCLUSION_FRAMES, device="cuda", seed=21,
                     pipeline="scan"):
    """Section 2: the ghost and global PSNRs with robustness on and off,
    and the ghost region's share of the scored pixels, through the
    ``pipeline`` form."""
    ref, comps, truth, ghost = make_occlusion_burst(size, size, n_frames=frames,
                                                    alpha=ALPHA, beta=BETA, seed=seed,
                                                    max_shift=2.0)
    crop = 2 * int(build_config(size, size).block_matching.tuning.tile_size)
    inner = np.zeros(ghost.shape, bool)
    inner[crop:-crop, crop:-crop] = True
    out = {"size": [size, size], "frames": frames,
           "ghost_fraction": float(ghost[inner].mean())}
    for label, enabled in (("on", True), ("off", False)):
        c = build_config(size, size, pipeline)
        c.robustness.enabled = enabled
        if not enabled:
            c.robustness.save_mask = False
        img = run_pipeline(ref, comps, c, device)
        out[f"psnr_ghost_{label}_db"] = compute_psnr(img[inner & ghost],
                                                     truth[inner & ghost])
        out[f"psnr_global_{label}_db"] = compute_psnr(img[inner], truth[inner])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipeline", choices=("scan", "chunked", "fused"),
                    default="scan")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    result = {"alpha": ALPHA, "beta": BETA, "device": str(device),
              "pipeline": args.pipeline}
    truth = score_truth(device=device, pipeline=args.pipeline)
    result["truth"] = truth
    print(f"[truth {TRUTH_SIZE}x{TRUTH_SIZE} x{TRUTH_FRAMES}] PSNR = "
          f"{truth['psnr_db']:.3f} dB ({truth['seconds']:.2f} s)", flush=True)
    rob = score_robustness(device=device, pipeline=args.pipeline)
    result["robustness_value"] = rob
    for label in ("on", "off"):
        print(f"[occlusion {OCCLUSION_SIZE}x{OCCLUSION_SIZE} x{OCCLUSION_FRAMES} "
              f"rob={label}] ghost PSNR = {rob[f'psnr_ghost_{label}_db']:.3f} dB, "
              f"global = {rob[f'psnr_global_{label}_db']:.3f} dB", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
