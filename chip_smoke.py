#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hmsr_tpu_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases, each printing its result lines (any failure raises: non-zero exit
and no final ``ok`` line); every line with a time carries the card's name
and power limit:

0. require CUDA; print the card (``nvidia-smi`` name and power limit) and
   the torch / CUDA versions;
1. build the eleven kernels (K1 block matching, K2 ICA Gauss-Newton steps,
   K3 fused ICA, K4 upscale-warp, K5 merge, K5' burst-fused merge, K6 the
   fused form's burst-and-reference merge, K7 its refill and divide, K8 the
   raw burst's normalization, K9 RAW10/RAW12 unpacking, K10 a compared
   frame's robustness map) and the probes P1 and P2 from
   ``hmsr_tpu_torch/csrc``;
   print the build seconds, each kernel's registers, static shared memory
   and spills from the build's kept ``-Xptxas -v`` report (per
   instantiation of a templated kernel: K5 and K5' have one per variant,
   ``merge_kernel<G,ISO>`` with G = 2 Bayer, 1 grey and ISO = 1 for the
   isotropic kernel), the launch layouts that the library computes for K1
   per (ts, r, metric), K2 and K3 per ts, K4 per (Ts, u, c), K5/K5' per
   (Ts, scale, variant) and K10 per (Ts, mode) (the library's against the
   wrapper's), and the static SASS instructions of every
   instantiation of K1-K10 (``cuobjdump -sass`` of the library), in all
   and in each one's longest loop (K5''s frame loop);
2. each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main path's shapes (20x12 MP burst, x2): the alignment
   levels at Ts=16, 32 and 64 (K2 as all n_iter steps of a level and as
   its single step; K2 against K3 without its search, bit for bit), K4,
   K5 and K5' (5 frames) at Ts=16, 32 and
   64, K4 also at grey mode's one channel and no upscale, K5' also against
   5 K5 launches (bit for bit), and K5/K5' in their other three variants
   (grey-steerable, Bayer-iso, grey-iso) at the same shapes, Ts=16, grey
   mode's covariances on the raw grid; K1-K4 at shapes off the main paths,
   which reach their instantiations with run-time tile size, radius and
   upscale (K1: ts 8, 12, 16, 24 with r 1, 2, 4, 16; K2 and K3: ts 12 and
   24, and every fixed ts on a level with a flat (singular) tile; K4: 4 and
   2 channels, u=4, Ts=6 on a width that is no multiple of 4), untimed;
   K10 against the chain of torch ops around K4 that is its plain version
   (max|d| <= 1e-6, the same zero set), Bayer at Ts=16, 32 and 64 and grey
   at Ts=16 on 3000x4000 (timed), and untimed at run-time tile sizes (6, 8)
   and raw sizes that are no multiple of Ts, 4 or 2, every one with border
   tiles' flows pushing their windows out of the grid;
   then K5 and K5' in every variant at
   scales 1, 2 and 3, Ts=16, 32 and 64, on 1024x1024 frames; max|d|, the
   kernel's device time alone (:func:`hmsr_tpu_torch.measure.timed`: back
   to back behind a held stream, between CUDA events), the wrapper's host
   time per call apart, the plain version's time (events around its
   calls, the card's waits for the host included) and the bound;
3. the 512x512 8-frame slice on the card against the slice on the CPU, in
   the scan and the chunked form (chunks of 3: the last one shorter): flow
   max|d| < 1e-2, image mean|d| < 1e-4 and max|d| < 1e-3 on the interior;
   chunked equal to scan on the card; then the same slice in grey mode,
   with the isotropic kernel and both (card scan against CPU scan, card
   chunked equal to card scan, launch counts asserted);
4. the scan pipeline (``tpu.pipeline: scan``; the line before it names the
   form the default ``auto`` resolves to, fused) on a 20-frame 3000x4000
   Bayer burst made on the card from a seed, x2, warm-up + 3 timed runs;
   kernel launch counts of every run asserted against what the path
   implies; finite interior;
5. ``process_arrays`` on the same burst (Monte-Carlo noise curves on the
   card, device finishing), scan and chunked (chunks of 5), warm-up + 3
   timed runs each, launch counts of every run asserted; the two images
   equal; shape, finite interior, peak memory;
6. the dark cells through ``process_arrays`` (scan): bursts of brightness
   0.07 and 0.02, which must resolve Ts=32 and Ts=64 from their SNR;
   launch counts asserted, finite interior, times;
7. the probes, which are not on the path: P1 (per-block fixed cost: empty,
   staging and arithmetic bodies over 16k and 64k blocks) and P2 (row-block
   sum of the grey image and its pyramid level 2) against their plain
   versions (:mod:`hmsr_tpu_torch.probe_cta_cost`);
8. the ``bench.py`` cells grey, x3 and x1 on the phase 4 burst, the
   pipeline alone on the scan form: grey (``mode: grey``) scan warm-up + 3
   timed runs, then
   chunked once (equal to scan) and ``process_arrays`` once with the device
   finishing (6000x8000x3); x3 (scale 3, the accumulated-robustness
   denoiser in the reference merge) and x1 (scale 1, robustness off)
   warm-up + 3 timed runs; launch counts, image shapes, finite interiors
   and peak memory of every run;
9. the pipeline's switches (:data:`SWITCHES`, on the scan form): (a) the
   512x512 8-frame slice on the card against the CPU with phase 3's bounds
   at x1.5 (Bayer,
   grey, with the merge denoiser), x2.5, the decimating grey (also chunked
   equal to scan), bilinear and bicubic flow upscaling, and
   ``process_arrays`` with the Gauss and with the median frame-count
   denoiser (ISO-keyed curves, finishing off); (b) on the phase 4 burst:
   x1.5 warm-up + 3 timed runs (K5 0: the gather merge), and once each the
   decimating grey, bilinear and bicubic at x2 and ``process_arrays`` at
   x2 with each denoiser (device finishing; the denoiser also timed alone);
   launch counts, shapes, finite interiors and peak memory of every run;
   (c) PSNR against ground truth (:mod:`hmsr_tpu_torch.score_accuracy`):
   the 512x512 20-frame burst and the ghost/global scores of the 384x384
   12-frame occlusion burst with robustness on and off, each within 0.05
   dB of the JAX package's scan-pipeline record ``ACCURACY_JAX_SCAN.json``
   (``tests/score_jax_scan.py``); the truth and robustness-off scores also
   within 0.05 dB of ``ACCURACY_r05.json``, the robustness-on ones also
   within 0.05 dB of the port's scores on the CPU (:func:`phase_accuracy`
   says why), each printed beside the records'.
10. the user's entry (:func:`phase_entry`): (a) the phase 4 burst written as
   an ``.npz`` bundle (``np.savez``, uncompressed) under ``build/``; (b) the
   port's CLI (``hmsr_tpu_torch.run_handheld``) on it in a subprocess at
   ``verbose=2``, the default configuration (``auto``: the fused form):
   exit 0, the kernels' launches of that form (:data:`DEFAULT_FORM`), peak
   memory under its :data:`MAX_PEAK_GIB`, no JAX loaded, an 8000x6000 8-bit
   RGB PNG and its ``.rob.png``; its split as the CLI prints it (load,
   pipeline, finishing, save) and its wall; (c) ``process`` on the bundle
   in-process once per finishing route (the default ``auto``: the device
   chain; the device chain with tonemapping; ``host``; ``host`` with
   tonemapping, cv2 made unavailable so that it is the plain smoothstep),
   launch counts and peaks asserted (the fused form), each host route
   within 1e-5 of its device route, the finishing timed apart; (d) the graft
   entry (:mod:`hmsr_tpu_torch.graft_entry`) on the card against the CPU;
   (e) ``unprocess_isp`` on a 3000x4000x3 image on the card against the
   CPU with the same generators (1e-6); (f) RAW10 and RAW12 unpacking of
   12 MP of random bytes through ``io.unpack`` on the card (K9, one launch
   per call), bit for bit against the CPU.
11. the multi-device path on ``torch.distributed`` (:func:`phase_sharded`),
   every rank on this one card: (a) K5 into 2, 3 and 4 bands of whole tile
   rows (the banded branch, ``row_offset``) at 3000x4000 x2, Ts=16, 32 and
   64 and the other three variants at Ts=16: the bands concatenated equal
   one full launch bit for bit, each band within 1e-5 relative of the
   banded plain version, each band's device time beside the full launch's;
   (b) and (c) in one spawn of 4 gloo ranks: the 512x512 8-frame slice on
   the meshes (2, 2), (4, 1) and (1, 4) against the card's single-device
   scan pipeline (phase 3's bounds, flows 1e-2, acc_r 1e-5, every rank the
   same image), then the phase 4 burst on the mesh (2, 2), warm-up + 3
   runs, per rank its walls, peak memory and launch counts (K5 10, every
   one into its band), the image against phase 4's under phase 3's bounds;
   the walls are of one card time-sliced between 4 processes, not of a
   scaling over cards; (d) one NCCL rank: the mesh (1, 1) on the slice equal
   to the scan pipeline bit for bit, and the process layer's broadcast of
   the Monte-Carlo curves on the NCCL group; (e)
   ``graft_entry.dryrun_multichip(4)`` over gloo.
12. the fused and vmapped forms (:func:`phase_fused_kernel` and after):
   (a) K6 (``csrc/merge_fused.cu``: every frame, then the reference frame,
   accumulators written once) against its plain version on the card, 19
   compared frames of 3000x4000 x2 at Ts=16, 32 and 64, the other three
   variants and the reference merge's denoiser at Ts=16, then scales 1 and
   3 on 1024x1024 (5 frames) in every variant and with the denoiser: 1e-5
   relative, and 1e-5 relative against K5' over the same frames into zeros
   followed by the plain reference merge; the values on either side of
   the refill's starvation threshold counted; device time, host us per
   call, the plain version's time, the bound, registers and spills; K7
   (``csrc/refill.cu``) on the main case's real accumulators: per slab and
   per tile on K6's against ``normalize_groups`` and the crop, and in the
   image layout on K5''s with the reference merge (the scan forms'
   accumulators) against ``normalize_accum(refill_border=32)``, bit for
   bit, timed;
   then K7 per slab and per tile on the stress input (starved values and
   blocks in every piece) at K6's padded geometry, Ts=16, 32 and 64 x2,
   grey, and x1 and x3 on 1024x1024, and K7's image layout against
   ``normalize_accum(refill_border=32)`` at the scan forms' bright, grey,
   x3 and x1.5 accumulators, 1024x1024 as strided planes and 60x75 (the
   refill everywhere, scalar), starved pixels at depths 0-3, 28-44 and
   inside: bit for bit, with the same numbers and the pieces that took
   the slow path; (b) the
   512x512 8-frame slice in the fused (slab and tiled) and vmapped forms,
   card against CPU with phase 3's bounds, in Bayer, grey, iso and with the
   denoiser, vmapped also against the card's scan, fused at x1.5 equal to
   scan; (c) the phase 4 burst in the fused form, warm-up + 3 timed runs
   (K6 1, K7 1, K5 0, K5' 0) and ``process_arrays`` once, peak memory against
   ``MAX_PEAK_GIB["fused"]``; x3 (the denoiser) fused once; vmapped once,
   against phase 4's scan image; (d) the fused form's PSNRs on the card,
   each within 0.05 dB of ``ACCURACY_r05.json`` (the JAX package's fused
   record).
13. raw ingestion (:func:`phase_normalize` and after): (a) K8
   (``csrc/ingest.cu``) against its plain version on the card, bit for
   bit, on 20x3000x4000 uint16 over 0-65535 from a seeded generator in the
   four CFA layouts at white levels 1023, 4095 and 65535 (blacks above many
   values), on 2x3001x4003, 3x7x9 and bases 2, 6 and 8 bytes off 16-byte
   alignment; the main case timed beside its plain version and bound, and
   the stack's uint16 upload beside the float32 upload it replaces; (b) K9
   against its plain version at 12 MP, RAW10 and RAW12, bit for bit,
   timed; (c) the phase 4 burst quantised to 10 bits (black 64, white
   balance 1.9/1.0/1.4), written as 20 empty ``.dng`` placeholders under
   ``build/`` and read through ``process(<folder>)`` in the default
   configuration (the fused form) with rawpy and exifread stood in
   (:class:`StandInRawpy`, :class:`StandInExifread` in ``sys.modules``,
   removed after): K8 1, the fused form's launches, the peak under
   ``MAX_PEAK_GIB["fused"]``, the image equal to ``process_arrays`` on the
   frames normalized by K8's plain version on the CPU (phase 3's bounds
   gate it); the load's split.

The line before the last is a JSON object with one entry per kernel (K5
and K5' with their four variants under ``variants``, K5 with its banded
branch under ``banded``, K6 and K7 with their cases under ``cases``, K7's
of both layouts, K8 with its uploads, K9 with RAW12 beside RAW10); the
last line is
``{"ok": true, "device": {...}}``. The script imports neither JAX nor the
JAX package ``hmsr_tpu``.
"""

import contextlib
import copy
import io
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hmsr_tpu_torch import configs, graft_entry, probe_cta_cost, score_accuracy
from hmsr_tpu_torch.finishing.denoise import (frame_count_denoising_gauss,
                                              frame_count_denoising_median)
from hmsr_tpu_torch.finishing.unprocess import unprocess_isp
from hmsr_tpu_torch.io import native_loader
from hmsr_tpu_torch.io.burst import load_burst
from hmsr_tpu_torch.io.unpack import unpack_raw10, unpack_raw12
from hmsr_tpu_torch.measure import bound, card, timed
from hmsr_tpu_torch.models.alignment import (FUSED_GN_MAX_TILES, _level_tile_sizes,
                                             init_alignment)
from hmsr_tpu_torch.models.ica import init_ica
from hmsr_tpu_torch.models.kernels import estimate_kernels
from hmsr_tpu_torch.models.pipeline import (_use_tiled, accum_shape, make_pipeline,
                                             pipeline_form, to_grey)
from hmsr_tpu_torch.models.process import process, process_arrays, use_device_finishing
from hmsr_tpu_torch.models.robustness import init_robustness
from hmsr_tpu_torch.ops import (_build, cuda_ica, cuda_ingest, cuda_merge, cuda_probes,
                                 cuda_robustness, cuda_warp)
from hmsr_tpu_torch.ops.accumfix import REFILL_BORDER, STARVED_DEN, normalize_accum
from hmsr_tpu_torch.ops.pyramid import build_gaussian_pyramid
from hmsr_tpu_torch.synthetic import (ALPHA, BETA, BENCH_CELLS, CFA_RGGB, WB,
                                      affine_curves, burst_config, burst_snr,
                                      edge_starved_accumulators, make_burst,
                                      starved_accumulators)

KERNELS = {  # key: name, wrapper, source, TPU kernel it replaces
    "K1": ("K1 block matching", cuda_ica.block_match, "hmsr_tpu_torch/csrc/bm.cu",
           "hmsr_tpu/ops/pallas_ica.py:756"),
    "K2": ("K2 ICA Gauss-Newton steps (all n_iter steps of a level, solve included)",
           cuda_ica.ica_steps, "hmsr_tpu_torch/csrc/ica_step.cu",
           "hmsr_tpu/ops/pallas_ica.py:447"),
    "K3": ("K3 fused ICA (all Gauss-Newton steps, optional L1 search)",
           cuda_ica.ica_fused, "hmsr_tpu_torch/csrc/ica_fused.cu",
           "hmsr_tpu/ops/pallas_ica_fused.py:175"),
    "K4": ("K4 robustness upscale-warp", cuda_warp.upscale_warp,
           "hmsr_tpu_torch/csrc/warp.cu", "hmsr_tpu/ops/pallas_warp.py:279"),
    "K5": ("K5 merge accumulation", cuda_merge.merge_accumulate,
           "hmsr_tpu_torch/csrc/merge.cu", "hmsr_tpu/ops/pallas_merge.py:641"),
    "K5'": ("K5' burst-fused merge accumulation (chunk of frames)",
            cuda_merge.merge_burst_accumulate, "hmsr_tpu_torch/csrc/merge_burst.cu",
            "hmsr_tpu/ops/pallas_merge.py:302"),
    # replaces XLA code of the JAX package (no pl.pallas_call there)
    "K6": ("K6 burst-and-reference fused merge (every frame, then the reference)",
           cuda_merge.merge_fused_accumulate, "hmsr_tpu_torch/csrc/merge_fused.cu",
           "hmsr_tpu/models/merge_slab.py:31"),
    "K7": ("K7 refill and divide (per slab or tile in the fused form, the border strips "
           "of the whole accumulators in the others)", cuda_merge.refill_groups,
           "hmsr_tpu_torch/csrc/refill.cu", "hmsr_tpu/models/merge_slab.py:383"),
    # replace host C++ of the JAX package's loader (native/burst_loader.cpp)
    "K8": ("K8 raw burst normalization (black level, white level and white balance per "
           "CFA phase)", cuda_ingest.normalize_bayer, "hmsr_tpu_torch/csrc/ingest.cu",
           "hmsr_tpu/io/native_loader.py:59"),
    "K9": ("K9 MIPI RAW10/RAW12 unpacking", cuda_ingest.unpack_raw,
           "hmsr_tpu_torch/csrc/ingest.cu", "hmsr_tpu/io/native_loader.py:98"),
    # replaces XLA code of the JAX package around its warp kernel
    "K10": ("K10 robustness map (guide, means, K4's warp, distance, threshold, 5x5 "
            "minimum)", cuda_robustness.robustness_fused,
            "hmsr_tpu_torch/csrc/robustness.cu", "hmsr_tpu/models/robustness.py:239"),
}
#: probes of the JAX package's TPU tools, not on the path (their launch
#: counts stay out of the path's counts)
PROBES = {
    "P1": ("P1 per-block fixed cost (empty body)", cuda_probes.cta_probe,
           "hmsr_tpu_torch/csrc/probes.cu", "tools/probe_program_cost.py:55"),
    "P2": ("P2 row-block sum (8-row blocks)", cuda_probes.row_block_sum,
           "hmsr_tpu_torch/csrc/probes.cu", "tools/probe_l2ica3.py:46"),
}
MAIN_TS = 16            # the bright main path's tile size
CHUNK = 5               # tpu.merge_chunk of the chunked path
#: launches per bright 20-frame burst, scan and chunked (chunks of 5), from
#: frames already loaded (a DNG folder's load adds one K8)
BRIGHT_LAUNCHES = {
    "scan": {"K1": 76, "K2": 38, "K3": 38, "K4": 2, "K5": 19, "K5'": 0, "K6": 0,
             "K7": 1, "K8": 0, "K9": 0, "K10": 19},
    "chunked": {"K1": 76, "K2": 38, "K3": 38, "K4": 2, "K5": 0, "K5'": 4, "K6": 0,
                "K7": 1, "K8": 0, "K9": 0, "K10": 19},
    "fused": {"K1": 76, "K2": 38, "K3": 38, "K4": 2, "K5": 0, "K5'": 0, "K6": 1,
              "K7": 1, "K8": 0, "K9": 0, "K10": 19}}
#: peak device memory allowed per process_arrays run (measured 4.30 GiB scan,
#: 6.00 GiB chunked on an H100 80GB HBM3: the stacks of the chunked analysis
#: hold 19 robustness maps and covariance sets, ~1.6 GB); fused, also per
#: run of the pipeline alone: 5.15 GiB through process_arrays and 5.69
#: alone (the stacks, K6's padded num/den, 1.16 GB, written while the last
#: run's 0.58 GB image is still held)
MAX_PEAK_GIB = {"scan": 6.0, "chunked": 8.0, "fused": 7.5}
#: the form the default ``tpu.pipeline: auto`` runs at the main path (x2, the
#: tiled merge): the JAX package's choice off the TPU
DEFAULT_FORM = "fused"
MERGE_KERNELS = {"K5": "merge_kernel", "K5'": "merge_burst_kernel"}
FUSED_KERNEL = "merge_fused_kernel"     # K6, merge_fused_kernel<G,ISO>
REFILL_KERNEL = "refill_kernel"         # K7
ROBUSTNESS_KERNEL = "robustness_kernel"  # K10, robustness_kernel<C,TS>
INGEST_KERNELS = ("normalize_kernel", "unpack_kernel")   # K8, K9 (unpack_kernel<BITS>)
#: the variants of K5 and K5' (grey, iso), the main path's first
MERGE_VARIANTS = {"bayer-steerable": (False, False), "grey-steerable": (True, False),
                  "bayer-iso": (False, True), "grey-iso": (True, True)}
#: the instantiation of K2 and K3 that the bright main path runs most
ICA_KERNELS = {"K2": "ica_steps_kernel<16>", "K3": "ica_fused_kernel<16>"}
CARD = ""               # nvidia-smi name and power limit, set in main()
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def check_no_reference_imports():
    """The port runs without JAX and without the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hmsr_tpu"))
    if bad:
        raise AssertionError(f"modules of JAX or of hmsr_tpu were imported: {bad}")


def reset_counts():
    for _, fn, _, _ in KERNELS.values():
        fn.launches = 0
    cuda_merge.merge_accumulate.band_launches = 0


def sass_counts(bases):
    """``{kernel: (static SASS instructions, those of its longest loop)}``
    for every instantiation (``bm_kernel<16,4,1>``) of the kernels whose
    base names are ``bases``, in the built library (``cuobjdump -sass``);
    a loop is the span of a backward branch, 16 bytes per instruction."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", _build.library_path], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", text)[1:]:
        name = _build.kernel_name(part.split()[0])
        if name.split("<")[0] in bases:
            back = [(int(a, 16) - int(b, 16)) // 16 + 1 for a, b in re.findall(
                r"/\*([0-9a-f]{4,})\*/[^;\n]*?\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)", part)
                if int(b, 16) < int(a, 16)]
            out[name] = (len(re.findall(r"/\*[0-9a-f]{4,}\*/\s", part)),
                         max(back, default=0))
    return out


def phase_build(raw_shape):
    """Phase 1: build; print each kernel's ptxas resources, the launch
    layouts of K1-K5' and the static SASS counts of K1-K7. Returns the
    ptxas report."""
    _build.library()
    log(f"phase 1 built {len(KERNELS)} kernels of the path and {len(PROBES)} probes in "
        f"{_build.build_seconds:.2f} s [{CARD}]")
    with open(_build.ptxas_log) as f:
        report = _build.ptxas_report(f.read())
    for name, r in sorted(report.items()):
        log(f"  ptxas {name}: {r['registers']} registers, {r['smem_bytes']} B static "
            f"shared memory, spill stores {r['spill_stores']} B, spill loads "
            f"{r['spill_loads']} B, stack {r['stack_bytes']} B")
    for key, F in (("K5", 1), ("K5'", CHUNK)):
        for variant, (grey, iso) in MERGE_VARIANTS.items():
            lay = {(Ts, sc): cuda_merge.merge_layout(Ts, sc, F, grey, iso)
                   for Ts in (16, 32, 64) for sc in (1, 2, 3)}
            log(f"  {key} {variant} ({F} frame{'s' if F > 1 else ''}) launch layout: "
                "dynamic shared memory per block (HR rows per block) " + ", ".join(
                    f"Ts={Ts} x{sc} {g['smem_bytes']} B ({g['rows']})"
                    for (Ts, sc), g in lay.items()))
    for snr in (40, 18, 8):                             # Ts 16, 32, 64
        config = burst_config(raw_shape, snr)
        state = init_alignment(torch.zeros(raw_shape, device="cuda"), config)
        for l, (tiles, (_, ts, r, metric)) in enumerate(
                zip(state.tiles, _level_tile_sizes(config))):
            n = tiles.shape[0] * tiles.shape[1]
            if n < FUSED_GN_MAX_TILES and metric == "L1" and r == 1:
                continue                                # K3 searches it
            g = cuda_ica.bm_layout(ts, r, metric, n)
            log(f"  K1 Ts={config.block_matching.tuning.tile_size} level {l} "
                f"(ts={ts} r={r} {metric}, {n} tiles) launch layout: "
                f"{'its own instantiation' if g['fixed'] else 'run-time ts and r'}, "
                f"{g['tiles_per_warp']} tiles per warp x {g['lanes_per_tile']} lanes, "
                f"{g['threads']} threads per block, bands of {g['band']} tile rows, "
                f"{g['smem_bytes']} B dynamic shared memory")
    for ts in (8, 16, 32, 64, *ICA_RUNTIME):
        for name, fused, bm in (("K2", False, False), ("K3", True, False),
                                ("K3 with its search", True, True)):
            g = cuda_ica.ica_layout(ts, fused, bm)
            log(f"  {name} ts={ts} launch layout: "
                f"{'its own instantiation' if g['fixed'] else 'run-time ts'}, "
                f"{g['tiles_per_block']} tiles per block x {g['lanes_per_tile']} lanes, "
                f"{g['threads']} threads per block, {g['smem_bytes']} B dynamic "
                "shared memory")
    for Ts, u, c in ((16, 2, 3), (32, 2, 3), (64, 2, 3), (16, 1, 1), (64, 1, 1)):
        g = cuda_warp.warp_layout(Ts, u, c)
        log(f"  K4 Ts={Ts} u={u} c={c} launch layout: "
            f"{'its own instantiation' if g['fixed'] else 'run-time Ts and u'}, "
            f"{g['tiles']} tiles of a tile row per block of {g['threads']} threads "
            f"(4 pixels each), window {g['window']}x{g['window']}, "
            f"{g['smem_bytes']} B dynamic shared memory")
    for Ts in (16, 32, 64, *(Ts for Ts, _, _ in ROB_RUNTIME)):
        for grey in (False, True):
            g = cuda_robustness.library_layout(Ts, grey)
            mine = cuda_robustness.robustness_layout(Ts, grey)
            if g != mine:
                raise AssertionError(f"K10 Ts={Ts} grey={grey}: the library's layout {g}, "
                                     f"the wrapper's {mine}")
            log(f"  K10 Ts={Ts} {'grey' if grey else 'Bayer'} launch layout: "
                f"{'its own instantiation' if g['fixed'] else 'run-time Ts'}, "
                f"{g['tiles_y']}x{g['tiles_x']} tiles per block of {g['threads']} threads, "
                f"{g['smem_bytes']} B dynamic shared memory")
    bases = {"bm_kernel", "ica_steps_kernel", "ica_fused_kernel", "warp_kernel",
             *MERGE_KERNELS.values(), FUSED_KERNEL, REFILL_KERNEL, *INGEST_KERNELS,
             ROBUSTNESS_KERNEL}
    for name, (n, loop) in sorted(sass_counts(bases).items()):
        log(f"  SASS {name}: {n} static instructions, {loop} in its longest loop")
    return report


def counts():
    return {key: k[1].launches for key, k in KERNELS.items()}


def check_counts(got, expect, what):
    """Counts equal to what the path implies, and every kernel of the path
    launched at least once."""
    if got != expect or not all(got[k] for k, v in expect.items() if v):
        raise AssertionError(f"{what}: kernel launch counts {got}, expected {expect}")


def nan_max_abs(a, b):
    """max |a - b| over entries where both are finite; raises if the NaN
    patterns differ."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError("finite masks differ")
    return float((a[fa] - b[fa]).abs().max()) if fa.any() else 0.0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def plain_text(ms):
    """The plain version's time, which is taken at the main path's Ts only."""
    return "not timed" if ms != ms else f"{ms:.4f} ms"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def blocky_scene(rng, h, w, block=8):
    base = rng.rand(h // block + 1, w // block + 1).astype(np.float32)
    return np.kron(base, np.ones((block, block), np.float32))[:h, :w]


def record(stats, key, Ts, per_frame, err, tk, plain_ms, bnd, **extra):
    """One row of phase 2: ``tk`` is the kernel's :class:`Timing` (device ms,
    host us per call)."""
    stats[key].append(dict(Ts=Ts, per_frame=per_frame, err=err, ms=tk.ms,
                           host_us=tk.host_us, plain_ms=plain_ms, bound_ms=bnd[0],
                           bound_by=bnd[1], **extra))


def time_text(tk):
    return f"kernel {tk.ms:.4f} ms (host {tk.host_us:.1f} us per call)"


def check_alignment_kernels(device, grey_shape, snr, rng, stats):
    """K1, K2 and K3 on every pyramid level of one configuration. Entries
    record whether the main path at this configuration launches the kernel
    on the level (each at most once a frame)."""
    h, w = grey_shape
    config = burst_config(grey_shape, snr)
    Ts = config.block_matching.tuning.tile_size
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
        n_px = ny * nx * ts * ts
        fused = ny * nx < FUSED_GN_MAX_TILES
        fused_bm = fused and metric == "L1" and radius == 1
        # integer, half-integer (round-half-even ties) and fractional flows
        fl = rng.uniform(-4, 4, (ny, nx, 2)).astype(np.float32)
        fl[::3] = np.round(fl[::3] * 2) / 2
        fl[0, 0] = (-60.0, 45.0)            # far outside the level
        flow = torch.as_tensor(fl, device=device)
        if metric == "L1":
            flow = torch.round(flow)
        key = f"Ts={Ts} level {l}: ts{ts} r{radius} {metric} tiles {ny}x{nx}"

        d_k = cuda_ica.block_match(tiles, mov_lvl, flow, ts, radius, metric)
        d_p = cuda_ica.block_match_plain(tiles, mov_lvl, flow, ts, radius, metric)
        n_diff = int((d_k != d_p).sum())
        tk = timed(lambda: cuda_ica.block_match(tiles, mov_lvl, flow, ts, radius,
                                                metric))
        ms_p = timed(lambda: cuda_ica.block_match_plain(tiles, mov_lvl, flow, ts,
                                                        radius, metric),
                     n=3, hold=False).ms
        # each candidate: L1 sub, abs, add; L2 two multiplies, two adds
        bnd = bound(nbytes(tiles, mov_lvl, flow, d_k),
                    n_px * (2 * radius + 1) ** 2 * (3 if metric == "L1" else 4))
        log(f"  K1 {key}: displacements differing {n_diff}, {time_text(tk)}, "
            f"plain {ms_p:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) [{CARD}]")
        if n_diff:
            raise AssertionError(f"K1 {key}: {n_diff} displacements differ")
        record(stats, "K1", Ts, 0 if fused_bm else 1, 0.0, tk, ms_p, bnd)

        # K2: all n_iter steps of the level from fractional flows; its
        # single step against one plain step; K3 without the search gives
        # the same bits
        fl2 = flow + torch.as_tensor(rng.uniform(-0.99, 0.99, (ny, nx, 2)).astype(
            np.float32), device=device)
        k2 = (lvl, ica.gradx, ica.grady, ica.terms, mov_lvl, fl2, ts)
        f_k = cuda_ica.ica_steps(*k2, n_iter)
        f_p = cuda_ica.ica_steps_plain(*k2, n_iter)
        err = float((f_k - f_p).abs().max())
        err1 = float((cuda_ica.ica_steps(*k2, 1) - cuda_ica.gn_update(
            fl2, cuda_ica.ica_step_plain(lvl, ica.gradx, ica.grady, mov_lvl, fl2, ts),
            ica.terms)).abs().max())
        same_k3 = torch.equal(cuda_ica.ica_fused(*k2, n_iter, False), f_k)
        tk = timed(lambda: cuda_ica.ica_steps(*k2, n_iter))
        ms_p = timed(lambda: cuda_ica.ica_steps_plain(*k2, n_iter), n=3, hold=False).ms
        # per tile pixel and step: 3 bilinear lerps (9), the residual (1), 2
        # products and 2 sums. The work as now done reads each input once;
        # the one-step design re-read the reference planes every step.
        bnd = bound(nbytes(lvl, ica.gradx, ica.grady, ica.terms, mov_lvl, fl2, f_k),
                    n_px * 14 * n_iter)
        step_bnd = n_iter * bound(nbytes(lvl, ica.gradx, ica.grady, mov_lvl, fl2, f_k),
                                  n_px * 14)[0]
        log(f"  K2 {key}, {n_iter} steps: flow max|d| {err:.3e}, one step {err1:.3e}, "
            f"K3 without search bit-identical: {same_k3}; {time_text(tk)}, "
            f"plain {ms_p:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), per-step bound {step_bnd:.4f} ms [{CARD}]")
        if not (err <= 1e-4 and err1 <= 1e-4 and same_k3):
            raise AssertionError(f"K2 {key}: flow max|d| {err:.3e}, one step "
                                 f"{err1:.3e}, K3 equal {same_k3}")
        record(stats, "K2", Ts, 0 if fused else 1, err, tk, ms_p, bnd,
               step_bound_ms=step_bnd)

        # K3 as the level would run it (the L1 search only on L1 r=1 levels),
        # from fractional flows with half-integer ties
        bm = metric == "L1" and radius == 1
        fl3 = fl2.clone()
        fl3[1::3] = torch.round(fl3[1::3] * 2) / 2
        args = (lvl, ica.gradx, ica.grady, ica.terms, mov_lvl, fl3, ts, n_iter, bm)
        f_k = cuda_ica.ica_fused(*args)
        f_p = cuda_ica.ica_fused_plain(*args)
        err = float((f_k - f_p).abs().max())
        tk = timed(lambda: cuda_ica.ica_fused(*args))
        ms_p = timed(lambda: cuda_ica.ica_fused_plain(*args), n=3, hold=False).ms
        bnd = bound(nbytes(lvl, ica.gradx, ica.grady, ica.terms, mov_lvl, fl3, f_k),
                    n_px * (14 * n_iter + (27 if bm else 0)))
        # the search alone (no steps): the displacements exactly
        n_search = int((cuda_ica.ica_fused(*args[:7], 0, True)
                        != cuda_ica.ica_fused_plain(*args[:7], 0, True)).sum()) if bm else 0
        log(f"  K3 {key}{' with L1 search' if bm else ''}: flow max|d| {err:.3e}"
            f"{f', searched flows differing {n_search}' if bm else ''}, "
            f"{time_text(tk)}, plain {ms_p:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}) [{CARD}]")
        if not (err <= 1e-4 and n_search == 0):
            raise AssertionError(f"K3 {key}: flow max|d| {err:.3e}, searched flows "
                                 f"differing {n_search}")
        record(stats, "K3", Ts, 1 if fused else 0, err, tk, ms_p, bnd)


#: K2 and K3 tile sizes that reach their instantiations with run-time ts
ICA_RUNTIME = (12, 24)


def check_gn_levels(device, rng, ny=6, nx=8):
    """K2 and K3 on synthetic levels at every fixed tile size and at
    :data:`ICA_RUNTIME`, against their plain versions: flows within 1e-4
    (K3 with and without the search), the searched flows exactly, K2 equal
    to K3 without the search bit for bit, and a singular tile (flat
    reference over the tile and the pixel row and column after it) keeping
    its flow exactly. Flows with negative fractions, half-integer ties and a
    window fully outside the level. Not timed."""
    for ts in (8, 16, 32, 64, *ICA_RUNTIME):
        for fused in (False, True):
            if cuda_ica.ica_layout(ts, fused)["fixed"] != (ts not in ICA_RUNTIME):
                raise AssertionError(f"{'K3' if fused else 'K2'} ts={ts}: instantiation "
                                     f"not the expected one")
        h, w = ny * ts + 3, nx * ts + 5     # a width that is no multiple of 4
        scene = blocky_scene(rng, h + 8, w + 8, block=max(2, ts // 4))
        ref = scene[:h, :w] + 0.01 * rng.randn(h, w).astype(np.float32)
        ref[:ts + 1, :ts + 1] = 0.0
        ref_t = torch.as_tensor(ref, device=device)
        mov = torch.as_tensor(scene[2:h + 2, 1:w + 1]
                              + 0.01 * rng.randn(h, w).astype(np.float32), device=device)
        st = init_ica(ref_t, ts)
        fl = rng.uniform(-2.5, 2.5, (ny, nx, 2)).astype(np.float32)
        fl[1::3] = np.round(fl[1::3] * 2) / 2
        fl[0, 1] = (-1.75, -0.25)
        fl[-1, -1] = (-60.0, 45.0)
        flow = torch.as_tensor(fl, device=device)
        args = (ref_t, st.gradx, st.grady, st.terms, mov, flow, ts, 3)
        f2 = cuda_ica.ica_steps(*args)
        err2 = float((f2 - cuda_ica.ica_steps_plain(*args)).abs().max())
        same = torch.equal(cuda_ica.ica_fused(*args, False), f2)
        kept = float(st.terms[0, 0, 0]) == 0.0 and torch.equal(f2[0, 0], flow[0, 0])
        err3 = float((cuda_ica.ica_fused(*args, True)
                      - cuda_ica.ica_fused_plain(*args, True)).abs().max())
        n_search = int((cuda_ica.ica_fused(*args[:7], 0, True)
                        != cuda_ica.ica_fused_plain(*args[:7], 0, True)).sum())
        log(f"  K2/K3 ts={ts} level {(h, w)}: K2 flow max|d| {err2:.3e}, K3 = K2 "
            f"bit-identical: {same}, singular tile kept: {kept}; K3 with search flow "
            f"max|d| {err3:.3e}, searched flows differing {n_search}")
        if not (err2 <= 1e-4 and same and kept and err3 <= 1e-4 and n_search == 0):
            raise AssertionError(f"K2/K3 ts={ts}: {err2:.3e}, {same}, {kept}, {err3:.3e}, "
                                 f"{n_search}")


def random_flow(rng, H, W, Ts, device, lead=()):
    fl = rng.uniform(-3, 3, lead + (-(-H // Ts), -(-W // Ts), 2)).astype(np.float32)
    fl[..., 0, :4, :] = (-40.0, 7.5)        # trips ok_tile at the border
    fl[..., -1, -4:, :] = (33.0, 41.0)
    return torch.as_tensor(fl, device=device)


def check_warp_kernel(device, raw_shape, Ts, rng, stats, time_plain, c=3, u=2):
    """K4 on (c, H/u, W/u) stats against its plain version: masks exact,
    max|d| <= 1e-5. The main path's call is c=3, u=2; grey mode's c=1, u=1."""
    H, W = raw_shape
    lh, lw = H // u, W // u
    st = torch.as_tensor(rng.rand(c, lh, lw).astype(np.float32), device=device)
    flow = random_flow(rng, H, W, Ts, device)
    o_k, v_k = cuda_warp.upscale_warp(st, u, Ts, flow, (H, W))
    o_p, v_p = cuda_warp.upscale_warp_plain(st, u, Ts, flow, (H, W))
    err = nan_max_abs(o_k, o_p)
    n_mask = int((v_k != v_p).sum())
    tk = timed(lambda: cuda_warp.upscale_warp(st, u, Ts, flow, (H, W)))
    ms_p = timed(lambda: cuda_warp.upscale_warp_plain(st, u, Ts, flow, (H, W)),
                 n=3, hold=False).ms if time_plain else float("nan")
    # per output pixel: 9 taps x (2 Dodgson weights ~8, their product, c
    # channel multiply-adds, the weight sum) and c divisions
    bnd = bound(nbytes(st, flow, o_k, v_k), H * W * (9 * (10 + 2 * c) + c))
    log(f"  K4 Ts={Ts} u={u} stats {(c, lh, lw)} -> {(c, H, W)}: max|d| {err:.3e}, "
        f"valid masks differing {n_mask} (invalid pixels {int((~v_p).sum())}), "
        f"{time_text(tk)}, plain {plain_text(ms_p)}, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}) [{CARD}]")
    if not (err <= 1e-5 and n_mask == 0):
        raise AssertionError(f"K4 Ts={Ts} u={u} c={c}: max|d| {err:.3e}, {n_mask} mask "
                             f"differences")
    record(stats, "K4", Ts, 1 if (c, u) == (3, 2) else 0, err, tk, ms_p, bnd)


#: K1 shapes (ts, r, metric) that reach its instantiation with run-time ts
#: and r: a tile size of its own, tile sizes that are not a multiple of the
#: staged band (8 at r=1, 16 at r=4), and a radius whose 2r+1 candidate rows
#: exceed a warp (passes of rows, and of BM_CHAINS columns)
BM_RUNTIME = ((8, 1, "L1"), (12, 1, "L1"), (16, 2, "L1"), (24, 4, "L2"),
              (8, 16, "L2"), (12, 16, "L1"))
#: K4 (Ts, u, c, H, W) that reach its instantiations with run-time Ts and u:
#: four and two channels, and a Ts and W that are not multiples of 4 (the
#: scalar tail)
WARP_RUNTIME = ((16, 2, 4, 1000, 1500), (32, 4, 2, 1000, 1500),
                (6, 3, 3, 999, 1502))


def check_runtime_instantiations(device, rng, h=600, w=808):
    """K1 and K4 at shapes off the main paths, which their run-time
    instantiations serve, against their plain versions: K1 0 displacements
    differing (far-out tiles whose windows tie included), K4 masks exact and
    max|d| <= 1e-5. Not timed."""
    scene = blocky_scene(rng, h + 8, w + 8)
    ref = torch.as_tensor(scene[:h, :w] + 0.01 * rng.randn(h, w).astype(np.float32),
                          device=device)
    mov = torch.as_tensor(scene[3:h + 3, 5:w + 5]
                          + 0.01 * rng.randn(h, w).astype(np.float32), device=device)
    for ts, r, metric in BM_RUNTIME:
        ny, nx = h // ts, w // ts
        if cuda_ica.bm_layout(ts, r, metric, ny * nx)["fixed"]:
            raise AssertionError(f"K1 ts={ts} r={r} {metric} has an instantiation of "
                                 f"its own")
        tiles = ref[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)
        fl = rng.uniform(-4, 4, (ny, nx, 2)).astype(np.float32)
        fl[::3] = np.round(fl[::3] * 2) / 2
        fl[0, 0] = (-60.0, 45.0)            # far outside the image
        flow = torch.as_tensor(fl, device=device)
        if metric == "L1":
            flow = torch.round(flow)
        d_k = cuda_ica.block_match(tiles, mov, flow, ts, r, metric)
        d_p = cuda_ica.block_match_plain(tiles, mov, flow, ts, r, metric)
        n_diff = int((d_k != d_p).sum())
        log(f"  K1 run-time ts and r: ts{ts} r{r} {metric} tiles {ny}x{nx}: "
            f"displacements differing {n_diff}")
        if n_diff:
            raise AssertionError(f"K1 ts={ts} r={r} {metric}: {n_diff} displacements "
                                 f"differ")
    for Ts, u, c, H, W in WARP_RUNTIME:
        if cuda_warp.warp_layout(Ts, u, c)["fixed"]:
            raise AssertionError(f"K4 Ts={Ts} u={u} c={c} has an instantiation of its own")
        st = torch.as_tensor(rng.rand(c, H // u, W // u).astype(np.float32), device=device)
        flow = random_flow(rng, H, W, Ts, device)
        o_k, v_k = cuda_warp.upscale_warp(st, u, Ts, flow, (H, W))
        o_p, v_p = cuda_warp.upscale_warp_plain(st, u, Ts, flow, (H, W))
        err = nan_max_abs(o_k, o_p)
        n_mask = int((v_k != v_p).sum())
        log(f"  K4 run-time Ts and u: Ts={Ts} u={u} stats {tuple(st.shape)} -> "
            f"{(c, H, W)}: max|d| {err:.3e}, valid masks differing {n_mask} (invalid "
            f"pixels {int((~v_p).sum())})")
        if not (err <= 1e-5 and n_mask == 0):
            raise AssertionError(f"K4 Ts={Ts} u={u} c={c}: max|d| {err:.3e}, {n_mask} "
                                 f"mask differences")


#: K10 (Ts, grey, raw shape) off the main paths: Ts at run time, raw sizes
#: that are no multiple of Ts, of 4 or (Bayer) of 2
ROB_RUNTIME = ((8, False, (1001, 1502)), (6, False, (998, 1499)), (6, True, (999, 1502)),
               (16, False, (3001, 4003)), (64, True, (1000, 1499)))
#: K10's bounds against its plain version on the card
ROB_MAX_ABS = 1e-6


def robustness_inputs(device, raw_shape, Ts, rng, grey):
    """A reference and a compared frame (blocky scene, noise, a shift and a
    moved block), the reference's statistics at ``Ts`` (K4) and a flow with
    border tiles pushed out of the grid: K10's arguments."""
    h, w = raw_shape
    scene = blocky_scene(rng, h + 8, w + 8)
    noise = 0.01 * rng.randn(2, h, w).astype(np.float32)
    ref = scene[:h, :w] + noise[0]
    comp = scene[2:h + 2, 1:w + 1] + noise[1]
    comp[h // 3:h // 2, w // 4:w // 2] += 0.3
    config = burst_config((3000, 4000), 40)     # the robustness tuning
    config.block_matching.tuning.tile_size = Ts
    config.mode = "grey" if grey else "bayer"
    std, diff = affine_curves()
    wb = [1.9, 1.0, 1.4]
    curves = (torch.as_tensor(std, device=device), torch.as_tensor(diff, device=device))
    stats = init_robustness(torch.as_tensor(ref, device=device), CFA_RGGB, wb, curves,
                            config)
    u = 1 if grey else 2
    flow = random_flow(rng, h // u * u, w // u * u, Ts, device)
    tun = config.robustness.tuning
    return (torch.as_tensor(comp, device=device), stats, flow, CFA_RGGB, wb, grey, Ts,
            tun.Mt, tun.s1, tun.s2, tun.t)


def check_robustness_kernel(device, raw_shape, Ts, rng, stats, timed_too, time_plain,
                            grey=False):
    """K10 on one frame against its plain version (the chain of torch ops
    around K4, on the card): max|d| <= ROB_MAX_ABS and the same zero set.
    Main-path entries (Bayer at 3000x4000) count one launch a frame."""
    args = robustness_inputs(device, raw_shape, Ts, rng, grey)
    r_k = cuda_robustness.robustness_fused(*args)
    r_p = cuda_robustness.robustness_plain(*args)
    torch.cuda.synchronize()
    err = nan_max_abs(r_k, r_p)
    n_zero = int(((r_k == 0) != (r_p == 0)).sum())
    what = (f"K10 Ts={Ts} {'grey' if grey else 'Bayer'} raw {raw_shape} -> "
            f"{tuple(r_k.shape)}: max|d| {err:.3e}, zero sets differing at {n_zero} "
            f"(zeros {int((r_p == 0).sum())} of {r_p.numel()})")
    if not (err <= ROB_MAX_ABS and n_zero == 0):
        raise AssertionError(what)
    if not timed_too:
        log(f"  {what}")
        return
    comp, ref_stats, flow = args[:3]
    tk = timed(lambda: cuda_robustness.robustness_fused(*args))
    ms_p = timed(lambda: cuda_robustness.robustness_plain(*args), n=3,
                 hold=False).ms if time_plain else float("nan")
    c = 1 if grey else 3
    # per raw pixel: 9 taps (the weight, c multiply-adds, the weight sum), c
    # divisions, 8 c for the distance, 4 for exp, threshold and clamp, 25
    # minima; the guide and means per window element are counted in neither
    bnd = bound(nbytes(comp, *ref_stats, flow, r_k),
                r_k.numel() * (9 * (2 + 2 * c) + 9 * c + 29))
    log(f"  {what}, {time_text(tk)}, plain {plain_text(ms_p)}, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}) [{CARD}]")
    record(stats, "K10", Ts, 0 if grey or tuple(raw_shape) != (3000, 4000) else 1, err, tk,
           ms_p, bnd, grey=grey)


def check_robustness_kernels(device, raw_shape, rng, stats):
    """K10 at the main paths' Ts, Bayer and grey (timed), and at
    :data:`ROB_RUNTIME` (untimed)."""
    for Ts in (16, 32, 64):
        check_robustness_kernel(device, raw_shape, Ts, rng, stats, True, Ts == MAIN_TS)
    check_robustness_kernel(device, raw_shape, MAIN_TS, rng, stats, True, True, grey=True)
    for Ts, grey, shape in ROB_RUNTIME:
        check_robustness_kernel(device, shape, Ts, rng, stats, False, False, grey=grey)


def merge_flops(iso):
    """Float operations of one frame at one HR pixel of K5/K5': 9 taps x
    (the exponent: 8 for the quadratic form, 4 for the isotropic
    ``2 (dx^2 + dy^2)``; 1 exp, 2 for the weight, 2 to accumulate), and for
    the steerable kernel 25 for the covariance interpolation and the 2x2
    inverse."""
    return 9 * ((4 if iso else 8) + 5) + (0 if iso else 25)


def merge_instance(base, grey, iso):
    """The kernel instantiation of a variant: ``merge_kernel<G,ISO>``."""
    return f"{base}<{1 if grey else 2},{int(iso)}>"


def check_merge_kernels(device, raw_shape, Ts, rng, stats, time_plain, F=CHUNK,
                        s=2, variant="bayer-steerable"):
    """K5 on one frame and K5' on a chunk of F frames against their plain
    versions (1e-5 relative), and K5' against F K5 launches (bit for bit),
    at scale ``s`` in one of :data:`MERGE_VARIANTS` (grey mode: covariances
    on the raw grid, one accumulator plane); entries count for the main path
    only at s=2 in the Bayer steerable variant."""
    H, W = raw_shape
    grey, iso = MERGE_VARIANTS[variant]
    main = 1 if (s == 2 and variant == "bayer-steerable") else 0
    n_ch = 1 if grey else 3
    config = burst_config(raw_shape, 40)
    config.mode = "grey" if grey else "bayer"
    comp = torch.stack([torch.as_tensor(np.clip(
        blocky_scene(rng, H, W, 4) + 0.02 * rng.randn(H, W), 0, 1).astype(np.float32),
        device=device) for _ in range(F)])
    covs = torch.stack([estimate_kernels(c, config) for c in comp]).contiguous()
    flows = random_flow(rng, H, W, Ts, device, lead=(F,))
    r = torch.as_tensor(rng.rand(F, H, W).astype(np.float32), device=device)
    base_n = torch.as_tensor(rng.rand(n_ch, s * H, s * W).astype(np.float32),
                             device=device)
    base_d = torch.as_tensor(rng.rand(n_ch, s * H, s * W).astype(np.float32),
                             device=device)
    acc_bytes = 2 * nbytes(base_n, base_d)              # read and written once
    # the isotropic kernel reads no covariance
    frame_bytes = nbytes(comp[0], flows[0], r[0]) + (0 if iso else nbytes(covs[0]))
    px = base_n[0].numel()
    tag = f"{variant} Ts={Ts} x{s}"
    kw = dict(grey=grey, iso=iso)

    def rel_errs(n_a, d_a, n_b, d_b):
        abs_n, abs_d = nan_max_abs(n_a, n_b), nan_max_abs(d_a, d_b)
        return (abs_n / float(n_b.abs().max()), abs_d / float(d_b.abs().max()),
                max(abs_n, abs_d))

    merge_args = (comp[0], flows[0], covs[0], r[0])
    n_k, d_k = base_n.clone(), base_d.clone()
    n_p, d_p = base_n.clone(), base_d.clone()
    cuda_merge.merge_accumulate(*merge_args, n_k, d_k, CFA_RGGB, Ts, s, **kw)
    cuda_merge.merge_plain(*merge_args, n_p, d_p, CFA_RGGB, Ts, s, **kw)
    err_n, err_d, err = rel_errs(n_k, d_k, n_p, d_p)
    tk = timed(lambda: cuda_merge.merge_accumulate(*merge_args, n_k, d_k, CFA_RGGB,
                                                   Ts, s, **kw))
    ms_p = timed(lambda: cuda_merge.merge_plain(*merge_args, n_p, d_p, CFA_RGGB,
                                                Ts, s, **kw), n=3, hold=False).ms \
        if time_plain else float("nan")
    bnd = bound(acc_bytes + frame_bytes, px * merge_flops(iso))
    log(f"  K5 {tag} comp {(H, W)} -> num/den {(n_ch, s * H, s * W)}: rel max|d| "
        f"num {err_n:.3e} den {err_d:.3e}, {time_text(tk)}, plain "
        f"{plain_text(ms_p)}, bound {bnd[0]:.4f} ms ({bnd[1]}) [{CARD}]")
    if not (err_n <= 1e-5 and err_d <= 1e-5):
        raise AssertionError(f"K5 {tag}: relative errors {err_n:.3e} / {err_d:.3e}")
    record(stats, "K5", Ts, main, err, tk, ms_p, bnd, variant=variant, s=s)
    del n_k, d_k, n_p, d_p

    burst_args = (comp, flows, covs, r)
    n_b, d_b = base_n.clone(), base_d.clone()
    cuda_merge.merge_burst_accumulate(*burst_args, n_b, d_b, CFA_RGGB, Ts, s, **kw)
    n_s, d_s = base_n.clone(), base_d.clone()
    for f in range(F):
        cuda_merge.merge_accumulate(comp[f], flows[f], covs[f], r[f], n_s, d_s,
                                    CFA_RGGB, Ts, s, **kw)
    d_seq = max(nan_max_abs(n_b, n_s), nan_max_abs(d_b, d_s))
    same = torch.equal(n_b, n_s) and torch.equal(d_b, d_s)
    del n_s, d_s
    n_p, d_p = base_n.clone(), base_d.clone()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cuda_merge.merge_burst_plain(*burst_args, n_p, d_p, CFA_RGGB, Ts, s, **kw)
    t1.record()
    torch.cuda.synchronize()
    err_n, err_d, err = rel_errs(n_b, d_b, n_p, d_p)
    del n_p, d_p
    tk = timed(lambda: cuda_merge.merge_burst_accumulate(*burst_args, n_b, d_b,
                                                         CFA_RGGB, Ts, s, **kw))
    ms_seq = timed(lambda: [cuda_merge.merge_accumulate(
        comp[f], flows[f], covs[f], r[f], n_b, d_b, CFA_RGGB, Ts, s, **kw)
        for f in range(F)]).ms
    ms_p = t0.elapsed_time(t1) if time_plain else float("nan")
    bnd = bound(acc_bytes + F * frame_bytes, F * px * merge_flops(iso))
    log(f"  K5' {tag} {F} frames: against {F} K5 launches max|d| {d_seq:.3e} "
        f"(bit-identical: {same}); against its plain version rel max|d| num "
        f"{err_n:.3e} den {err_d:.3e}; {time_text(tk)} per launch, {F} x K5 "
        f"{ms_seq:.4f} ms, plain {plain_text(ms_p)}, bound {bnd[0]:.4f} ms ({bnd[1]}) "
        f"[{CARD}]")
    if not (same and err_n <= 1e-5 and err_d <= 1e-5):
        raise AssertionError(f"K5' {tag}: against K5 max|d| {d_seq:.3e}, relative "
                             f"errors {err_n:.3e} / {err_d:.3e}")
    # per frame of the main path, as the other entries
    record(stats, "K5'", Ts, main / F, err, tk, ms_p, bnd, seq_ms=ms_seq,
           variant=variant, s=s)


def phase_kernels(device, raw_shape, seed=1):
    """Phase 2. Returns per-kernel lists of dicts: the configuration's tile
    size ``Ts``, ``per_frame`` (launches per frame of the main path at that
    Ts), max_abs_err ``err``, ``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``."""
    rng = np.random.RandomState(seed)
    stats = {key: [] for key in KERNELS}
    for snr in (40, 18, 8):                             # Ts 16, 32, 64
        check_alignment_kernels(device, raw_shape, snr, rng, stats)
    for Ts in (16, 32, 64):
        check_warp_kernel(device, raw_shape, Ts, rng, stats, Ts == MAIN_TS)
        check_merge_kernels(device, raw_shape, Ts, rng, stats, Ts == MAIN_TS)
    # grey mode's call: one channel, no upscale (the grey cell, phase 8)
    check_warp_kernel(device, raw_shape, MAIN_TS, rng, stats, False, c=1, u=1)
    # the other variants of K5 and K5' at the main path's shapes, timed
    for variant in list(MERGE_VARIANTS)[1:]:
        check_merge_kernels(device, raw_shape, MAIN_TS, rng, stats, True,
                            variant=variant)
    check_runtime_instantiations(device, rng)
    check_robustness_kernels(device, raw_shape, rng, stats)
    check_gn_levels(device, rng)
    for variant in MERGE_VARIANTS:
        for s in (1, 2, 3):
            for Ts in (16, 32, 64):
                if s != 2 or (variant != "bayer-steerable" and Ts != MAIN_TS):
                    check_merge_kernels(device, (1024, 1024), Ts, rng, stats, False,
                                        s=s, variant=variant)
    return stats


# ---------------------------------------------------------------------------
# phase 3: the slice on the card against the slice on the CPU
# ---------------------------------------------------------------------------

def phase_slice(device, size=512, n_frames=8, seed=2):
    """Phase 3. Returns ``{variant: {"K5": launches of its card scan run,
    "K5'": of its chunked run}}`` for the variants of K5/K5' other than the
    main path's."""
    frames = make_burst(size, size, n_frames, seed, device)
    std, diff = affine_curves()
    config = burst_config((size, size), 40, debug=True)
    res = {}
    for mode in ("scan", "chunked"):
        config["tpu"] = {"pipeline": mode, "merge_chunk": 3}
        outs = {}
        for dev in (device, "cpu"):
            burst = frames.to(dev)
            img, dbg = make_pipeline(config, CFA_RGGB, WB, dev)(burst[0], burst[1:],
                                                                 std, diff)
            outs[dev] = (img, dbg["flow"])
        (img_g, flow_g), (img_c, flow_c) = outs[device], outs["cpu"]
        res[mode] = slice_parity(img_g, flow_g, img_c, flow_c,
                                 f"phase 3 slice {size}x{size} x{n_frames} Ts="
                                 f"{config.block_matching.tuning.tile_size} {mode}")
        res[mode]["img"] = img_g
    d = float((res["chunked"]["img"] - res["scan"]["img"]).abs().max())
    log(f"phase 3 chunked vs scan on the card: image max|d| {d:.3e}")
    if d != 0.0:
        raise AssertionError(f"chunked and scan differ on the card: max|d| {d:.3e}")
    launches = {}
    for variant in list(MERGE_VARIANTS)[1:]:
        launches[variant] = slice_variant(frames, config, variant, device)
    return launches


def slice_parity(img_g, flow_g, img_c, flow_c, what):
    """The e2e bounds of the card's slice against the CPU's."""
    d_flow = float((flow_g.cpu() - flow_c).abs().max())
    d_img = (img_g.cpu() - img_c).abs()[8:-8, 8:-8]
    res = dict(flow_max=d_flow, img_mean=float(d_img.mean()), img_max=float(d_img.max()))
    log(f"{what}, card vs CPU: flow max|d| {d_flow:.3e}, image mean|d| "
        f"{res['img_mean']:.3e}, max|d| {res['img_max']:.3e}")
    if not (d_flow < 1e-2 and res["img_mean"] < 1e-4 and res["img_max"] < 1e-3):
        raise AssertionError(f"slice parity failed ({what}): {res}")
    return res


def slice_variant(frames, config, variant, device):
    """The slice in grey mode and/or with the isotropic kernel: the card's
    scan against the CPU's scan (e2e bounds), the card's chunked form equal
    to its scan, the launch counts of both asserted. Returns the K5
    launches of the scan run and the K5' launches of the chunked run."""
    grey, iso = MERGE_VARIANTS[variant]
    std, diff = affine_curves()
    config = copy.deepcopy(config)
    config.mode = "grey" if grey else "bayer"
    config.merging.kernel = "iso" if iso else "steerable"
    imgs, launches = {}, {}
    for mode, devs in (("scan", (device, "cpu")), ("chunked", (device,))):
        config["tpu"] = {"pipeline": mode, "merge_chunk": 3}
        for dev in devs:
            burst = frames.to(dev)
            reset_counts()
            imgs[mode, dev] = make_pipeline(config, CFA_RGGB, WB, dev)(
                burst[0], burst[1:], std, diff)
            if dev == device:
                launches[mode] = counts()
                check_counts(launches[mode],
                             expected_launches(frames[0], config, len(frames) - 1),
                             f"phase 3 {variant} {mode}")
    (img_g, dbg_g), (img_c, dbg_c) = imgs["scan", device], imgs["scan", "cpu"]
    n_ch = 1 if grey else 3
    if img_g.shape[-1] != n_ch:
        raise AssertionError(f"slice {variant}: image {tuple(img_g.shape)}")
    slice_parity(img_g, dbg_g["flow"], img_c, dbg_c["flow"],
                 f"phase 3 slice {variant} scan")
    d = float((imgs["chunked", device][0] - img_g).abs().max())
    log(f"phase 3 {variant} chunked vs scan on the card: image max|d| {d:.3e}; "
        f"launches scan {launches['scan']}, chunked {launches['chunked']}")
    if d != 0.0:
        raise AssertionError(f"{variant}: chunked and scan differ on the card: max|d| "
                             f"{d:.3e}")
    return {"K5": launches["scan"]["K5"], "K5'": launches["chunked"]["K5'"]}


# ---------------------------------------------------------------------------
# phase 4: the scan main path
# ---------------------------------------------------------------------------

def expected_launches(ref, config, n_cmp):
    """Launches per burst of each kernel that the path implies: per
    compared frame and level, K1 then K2 (all n_iter steps), or K3 on levels under
    FUSED_GN_MAX_TILES tiles (with its own L1 search on L1 radius-1 levels,
    else after K1); two K4 at init and one K10 per frame (none with
    robustness off); one K5 per frame
    (scan, vmapped), or one K5' per chunk of ``tpu.merge_chunk`` frames
    (chunked), or one K6 per burst (fused), and none of them at a
    fractional scale (the gather merge, plain torch; fused runs the scan
    form there); one K7 per burst in every form (per slab or tile in the
    fused form, the border strips otherwise); no K8 or K9 (the burst is
    loaded). With the decimating grey the levels are those of the half-size
    grey image."""
    state = init_alignment(to_grey(ref, config), config)
    k1 = k2 = k3 = 0
    for tiles, (_, _, radius, metric) in zip(state.tiles, _level_tile_sizes(config)):
        if tiles.shape[0] * tiles.shape[1] < FUSED_GN_MAX_TILES:
            k3 += 1
            k1 += 0 if (metric == "L1" and radius == 1) else 1
        else:
            k1 += 1
            k2 += 1
    form = pipeline_form(config)
    fc = max(1, min(int(config.get("tpu", {}).get("merge_chunk", 5)), n_cmp))
    rob = bool(config.robustness.enabled)
    tiled = _use_tiled(config)
    return {"K1": n_cmp * k1, "K2": n_cmp * k2, "K3": n_cmp * k3, "K4": 2 if rob else 0,
            "K5": n_cmp if tiled and form in ("scan", "vmapped") else 0,
            "K5'": -(-n_cmp // fc) if form == "chunked" else 0,
            "K6": 1 if form == "fused" else 0, "K7": 1, "K8": 0, "K9": 0,
            "K10": n_cmp if rob else 0}


def run_timed(fn, n_runs, expect_fn, what, device):
    """Warm-up + ``n_runs`` timed runs of ``fn()`` (host clock, ending in a
    synchronise); launch counts of every run checked against
    ``expect_fn()`` (evaluated after the warm-up). Returns (image, debug,
    times, launches, warm-up seconds)."""
    times, expect = [], None
    for i in range(n_runs + 1):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        image, debug = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        if expect is None:
            expect = expect_fn()
        check_counts(got, expect, what)
        sub = image[::31, ::37]
        checksum = float(torch.where(torch.isfinite(sub), sub,
                                     torch.zeros((), device=device)).sum())
        log(f"  {what} run {i} ({'warm-up' if i == 0 else 'timed'}): {dt:.4f} s, "
            f"checksum {checksum:.6f} [{CARD}]")
        if i:
            times.append(dt)
        else:
            warm = dt
    return image, debug, times, got, warm


def check_image(image, shape, what):
    if tuple(image.shape) != shape:
        raise AssertionError(f"{what}: image shape {tuple(image.shape)}, expected {shape}")
    if not bool(torch.isfinite(image[8:-8, 8:-8]).all()):
        raise AssertionError(f"{what}: non-finite values in the image interior")


def phase_full(frames, device, n_runs=3):
    h, w = frames.shape[1:]
    std, diff = affine_curves()
    snr = burst_snr(frames[0], std)
    config = burst_config((h, w), snr)
    log(f"phase 4: tpu.pipeline auto (the default) resolves to the "
        f"{pipeline_form(config)} form at this burst; this phase pins scan")
    config = scan_config(config)
    log(f"phase 4 scan pipeline, burst {tuple(frames.shape)}: SNR {snr:.1f} -> Ts="
        f"{config.block_matching.tuning.tile_size}, scale {config.scale}")
    ref, comps = frames[0], frames[1:]
    pipe = make_pipeline(config, CFA_RGGB, WB, device)
    std_t = torch.as_tensor(std, device=device)
    diff_t = torch.as_tensor(diff, device=device)
    torch.cuda.reset_peak_memory_stats()
    image, _, times, launches, _ = run_timed(
        lambda: pipe(ref, comps, std_t, diff_t), n_runs,
        lambda: expected_launches(ref, config, len(comps)), "phase 4", device)
    check_image(image, (2 * h, 2 * w, 3), "phase 4")
    peak = torch.cuda.max_memory_allocated()
    res = dict(min_s=min(times), median_s=statistics.median(times),
               peak_bytes=peak, launches=launches, image=image.cpu())
    log(f"phase 4 {len(frames)}x{h}x{w} x{config.scale}: min {res['min_s']:.4f} s, "
        f"median {res['median_s']:.4f} s of {n_runs}; peak memory "
        f"{peak / 2**30:.3f} GiB; launches per run {launches}; interior finite "
        f"[{CARD}]")
    return res


# ---------------------------------------------------------------------------
# phases 5 and 6: process_arrays
# ---------------------------------------------------------------------------

def process_config(mode):
    """The default configuration at x2 with the burst's affine noise model
    (so ``process_arrays`` draws its Monte-Carlo curves on the card), the
    default device finishing (sharpening + gamma), ``tpu.pipeline`` mode."""
    c = configs.default_config()
    c.scale = 2
    c.verbose = 0
    c.noise_model.update(alpha=ALPHA, beta=BETA)
    c["tpu"] = {"pipeline": mode, "merge_chunk": CHUNK}
    return c


def run_process(frames, mode, device, what, n_runs=3):
    """``process_arrays`` on ``frames``: warm-up + ``n_runs`` timed runs with
    fresh configurations, launch counts asserted; returns a dict with the
    last image, times, launches, the resolved Ts and the peak memory."""
    h, w = frames.shape[1:]
    cfgs = []

    def call():
        cfgs.append(process_config(mode))
        return process_arrays(frames[0], frames[1:], cfgs[-1], device=device)

    torch.cuda.reset_peak_memory_stats()
    image, debug, times, launches, warm = run_timed(
        call, n_runs, lambda: expected_launches(frames[0], cfgs[-1], len(frames) - 1),
        what, device)
    peak = torch.cuda.max_memory_allocated()
    check_image(image, (2 * h, 2 * w, 3), what)
    if peak > MAX_PEAK_GIB[mode] * 2**30:
        raise AssertionError(f"{what}: peak memory {peak / 2**30:.3f} GiB > "
                             f"{MAX_PEAK_GIB[mode]} GiB")
    if tuple(debug["accumulated_robustness"].shape) != (h, w):
        raise AssertionError(f"{what}: accumulated robustness "
                             f"{tuple(debug['accumulated_robustness'].shape)}")
    res = dict(image=image, min_s=min(times), median_s=statistics.median(times),
               warm_s=warm, launches=launches, peak_bytes=peak,
               Ts=cfgs[-1].block_matching.tuning.tile_size)
    log(f"{what}: Ts={res['Ts']}, warm-up {warm:.4f} s, min {res['min_s']:.4f} s, "
        f"median {res['median_s']:.4f} s of {n_runs}; peak memory "
        f"{peak / 2**30:.3f} GiB; launches per run {launches}; interior finite "
        f"[{CARD}]")
    return res


def phase_process(frames, device):
    """Phase 5: scan and chunked through ``process_arrays``; same image."""
    res = {mode: run_process(frames, mode, device, f"phase 5 process_arrays {mode}")
           for mode in ("scan", "chunked")}
    for mode in res:
        check_counts(res[mode]["launches"], BRIGHT_LAUNCHES[mode], f"phase 5 {mode}")
    a, b = res["scan"]["image"], res["chunked"]["image"]
    d = (a - b).abs()
    d_max = float(d.max())
    log(f"phase 5 scan vs chunked: image max|d| {d_max:.3e}, "
        f"{int((d > 0).sum())} values differ")
    if d_max != 0.0:
        raise AssertionError(
            f"phase 5: scan and chunked images differ (max|d| {d_max:.3e}); K5' is "
            f"held bit-identical to K5 and the analysis is the same, so the bound "
            f"is 0")
    return res


def phase_dark(device, h=3000, w=4000, n_frames=20, seed=0):
    """Phase 6: the dark cells (``bench.py``'s brightness 0.07 and 0.02)."""
    res = {}
    for name, b, want_ts in (("dark", 0.07, 32), ("dark64", 0.02, 64)):
        frames = make_burst(h, w, n_frames, seed, device, brightness=b)
        res[name] = run_process(frames, "scan", device,
                                f"phase 6 {name} (brightness {b}) process_arrays scan")
        del frames
        if res[name]["Ts"] != want_ts:
            raise AssertionError(f"phase 6 {name}: Ts={res[name]['Ts']}, expected "
                                 f"{want_ts} from the SNR")
        res[name].pop("image")
    return res


# ---------------------------------------------------------------------------
# phase 8: the bench.py cells grey, x3 and x1
# ---------------------------------------------------------------------------

#: peak device memory allowed per run of the phase 8 and 9 cells (GiB), set
#: from their first measurement on an H100 80GB HBM3 with the margin of
#: MAX_PEAK_GIB: grey scan 3.23 and process_arrays 3.05 (one accumulator
#: plane); grey chunked 7.82 (the stacks hold 19 covariance sets on the raw
#: grid, 2.7 GB, four times Bayer's); x3 7.70 (num, den and the image at
#: 9000x12000, 1.3 GB each); x1 1.96; x1.5 3.45; decimating 3.62, bilinear
#: and bicubic 3.75; process_arrays with the Gauss denoiser 3.75, with the
#: median 6.98 (a band's tap stack, its sorted copy and int64 indices: 4 GiB);
#: x3 fused 7.69 (K6's padded num/den at 9024x12000, 2.6 GB, beside the
#: stacks); vmapped 4.93 (the stacks, as chunked's, with one plane set of
#: num/den)
CELL_PEAK_GIB = {"grey scan": 4.5, "grey chunked": 10.0, "grey process_arrays": 4.5,
                 "x3 scan": 10.0, "x1 scan": 3.0,
                 "x1.5 scan": 4.5, "decimating scan": 5.0, "bilinear scan": 5.0,
                 "bicubic scan": 5.0, "process_arrays gauss": 5.0,
                 "process_arrays median": 9.5, "x3 fused": 10.0, "vmapped": 6.5}


def check_peak(peak, what, phase=8):
    if peak > CELL_PEAK_GIB[what] * 2**30:
        raise AssertionError(f"phase {phase} {what}: peak memory {peak / 2**30:.3f} GiB > "
                             f"{CELL_PEAK_GIB[what]} GiB")


def run_once(fn, expect_fn, what, shape):
    """One run of ``fn()`` -> ``(image, debug)``, host clock ending in a
    synchronise; its launch counts against ``expect_fn()`` (evaluated after
    the run), the image's shape and finite interior. Returns ``(image,
    seconds, launches, peak memory bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    image, _ = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got, peak = counts(), torch.cuda.max_memory_allocated()
    check_counts(got, expect_fn(), what)
    check_image(image, shape, what)
    return image, dt, got, peak


def run_cell(frames, config, what, device, n_runs=3, phase=8):
    """The pipeline alone on ``frames``: warm-up + ``n_runs`` timed runs,
    launch counts of every run asserted, image shape and finite interior,
    peak memory against :data:`CELL_PEAK_GIB`."""
    h, w = frames.shape[1:]
    std, diff = affine_curves()
    pipe = make_pipeline(config, CFA_RGGB, WB, device)
    std_t = torch.as_tensor(std, device=device)
    diff_t = torch.as_tensor(diff, device=device)
    ref, comps = frames[0], frames[1:]
    torch.cuda.reset_peak_memory_stats()
    image, _, times, launches, warm = run_timed(
        lambda: pipe(ref, comps, std_t, diff_t), n_runs,
        lambda: expected_launches(ref, config, len(comps)), f"phase {phase} {what}",
        device)
    peak = torch.cuda.max_memory_allocated()
    n_ch, out_h, out_w = accum_shape(config, (h, w))
    check_image(image, (out_h, out_w, n_ch), f"phase {phase} {what}")
    res = dict(image=image, min_s=min(times), median_s=statistics.median(times),
               warm_s=warm, launches=launches, peak_bytes=peak)
    log(f"phase {phase} {what}: image {tuple(image.shape)}, warm-up {warm:.4f} s, min "
        f"{res['min_s']:.4f} s, median {res['median_s']:.4f} s of {n_runs}; peak "
        f"memory {peak / 2**30:.3f} GiB; launches per run {launches}; interior finite "
        f"[{CARD}]")
    check_peak(peak, what, phase)
    return res


def phase_cells(frames, device):
    """Phase 8: the ``bench.py`` cells grey, x3 and x1 on the phase 4 burst.
    Grey: the scan pipeline timed, then the chunked pipeline once (equal to
    scan bit for bit) and ``process_arrays`` scan once with the device
    finishing (the one plane repeated to three). x3 (the accumulated-
    robustness denoiser in the reference merge) and x1 (robustness off):
    the scan pipeline timed. Returns ``{cell: result}``; the grey entry also
    holds the chunked run's launches."""
    h, w = frames.shape[1:]
    std, _ = affine_curves()
    snr = burst_snr(frames[0], std)
    res = {}
    for cell, mutate in BENCH_CELLS.items():
        config = scan_config(burst_config((h, w), snr))
        mutate(config)
        res[cell] = run_cell(frames, config, f"{cell} scan", device)
        if cell != "grey":
            res[cell].pop("image")
            continue
        # the chunked form once: K5' in place of K5, the same image
        config["tpu"] = {"pipeline": "chunked", "merge_chunk": CHUNK}
        image, dt, got, peak = run_once(
            lambda: make_pipeline(config, CFA_RGGB, WB, device)(
                frames[0], frames[1:], torch.as_tensor(std, device=device),
                torch.as_tensor(affine_curves()[1], device=device)),
            lambda: expected_launches(frames[0], config, len(frames) - 1),
            "phase 8 grey chunked", (2 * h, 2 * w, 1))
        d = float((image - res[cell]["image"]).abs().max())
        log(f"phase 8 grey chunked (once): {dt:.4f} s, image max|d| against scan "
            f"{d:.3e}; peak memory {peak / 2**30:.3f} GiB; launches {got} [{CARD}]")
        if d != 0.0:
            raise AssertionError(f"phase 8 grey: chunked and scan differ (max|d| "
                                 f"{d:.3e})")
        check_peak(peak, "grey chunked")
        res[cell].update(chunked_launches=got, chunked_peak_bytes=peak)
        del image, res[cell]["image"]
        # process_arrays with the device finishing, once
        pc = process_config("scan")
        pc.mode = "grey"
        image, dt, got, peak = run_once(
            lambda: process_arrays(frames[0], frames[1:], pc, device=device),
            lambda: expected_launches(frames[0], pc, len(frames) - 1),
            "phase 8 grey process_arrays", (2 * h, 2 * w, 3))
        log(f"phase 8 grey process_arrays scan (once, device finishing): {dt:.4f} s, "
            f"image {tuple(image.shape)}, Ts={pc.block_matching.tuning.tile_size}; "
            f"peak memory {peak / 2**30:.3f} GiB; launches {got} [{CARD}]")
        check_peak(peak, "grey process_arrays")
        res[cell].update(process_s=dt, process_peak_bytes=peak)
        del image
    return res


# ---------------------------------------------------------------------------
# phase 9: the pipeline's switches
# ---------------------------------------------------------------------------

#: the switches of phase 9: changes to the ``bench.py`` configuration (x2
#: unless a scale is given); ``denoiser`` enables the accumulated-robustness
#: denoiser of the reference merge
SWITCHES = {
    "x1.5": {"scale": 1.5},
    "x1.5-grey": {"scale": 1.5, "mode": "grey"},
    "x1.5-denoiser": {"scale": 1.5, "denoiser": True},
    "x2.5": {"scale": 2.5},
    "decimating": {"grey_method": "decimating"},
    "bilinear": {"flow_upscale_mode": "bilinear"},
    "bicubic": {"flow_upscale_mode": "bicubic"},
}
#: the frame-count denoisers that ``process_arrays`` runs after the pipeline
DENOISERS = {"gauss": frame_count_denoising_gauss, "median": frame_count_denoising_median}
#: the JAX package's accuracy records that phase 9 holds the port to: its
#: scan pipeline's (``tests/score_jax_scan.py``) and its round-5 record,
#: scored through the ``fused`` pipeline (dB)
ACCURACY_SCAN_RECORD = "ACCURACY_JAX_SCAN.json"
ACCURACY_RECORD = "ACCURACY_r05.json"
ACCURACY_TOL_DB = 0.05


def switch_config(shape, snr, name, debug=False):
    """The ``bench.py`` configuration with the switch ``name`` of
    :data:`SWITCHES`, on the scan form."""
    sw = SWITCHES[name]
    config = scan_config(burst_config(shape, snr, scale=sw.get("scale", 2), debug=debug))
    config.mode = sw.get("mode", "bayer")
    config.grey_method = sw.get("grey_method", "FFT")
    config.block_matching.tuning.flow_upscale_mode = sw.get("flow_upscale_mode", "nearest")
    config.accumulated_robustness_denoiser.enabled = sw.get("denoiser", False)
    configs.sanitize_config(config, shape)
    return config


def denoiser_config(which, finishing, mode="scan"):
    """:func:`process_config` with the ``which`` frame-count denoiser and
    the finishing on or off."""
    c = process_config(mode)
    c.accumulated_robustness_denoiser[which].enabled = True
    c.postprocessing.enabled = finishing
    return c


def phase_switch_slice(device, size=512, n_frames=8, seed=2):
    """Phase 9 (a): every switch on the 512x512 slice, card scan against CPU
    scan with phase 3's bounds, launch counts asserted; the decimating grey
    also chunked on the card, equal to its scan; ``process_arrays`` with
    each frame-count denoiser (ISO-keyed curves from ``data/``, so the two
    devices share them; finishing off), card against CPU."""
    frames = make_burst(size, size, n_frames, seed, device)
    std, diff = affine_curves()
    for name in SWITCHES:
        config = switch_config((size, size), 40, name, debug=True)
        modes = ("scan", "chunked") if name == "decimating" else ("scan",)
        outs = {}
        for mode in modes:
            config["tpu"] = {"pipeline": mode, "merge_chunk": 3}
            for dev in ((device, "cpu") if mode == "scan" else (device,)):
                burst = frames.to(dev)
                reset_counts()
                outs[mode, dev] = make_pipeline(config, CFA_RGGB, WB, dev)(
                    burst[0], burst[1:], std, diff)
                if dev == device:
                    check_counts(counts(), expected_launches(frames[0], config,
                                                             n_frames - 1),
                                 f"phase 9 slice {name} {mode}")
        (img_g, dbg_g), (img_c, dbg_c) = outs["scan", device], outs["scan", "cpu"]
        n_ch, out_h, out_w = accum_shape(config, (size, size))
        check_image(img_g, (out_h, out_w, n_ch), f"phase 9 slice {name}")
        slice_parity(img_g, dbg_g["flow"], img_c, dbg_c["flow"],
                     f"phase 9 slice {name} scan {tuple(img_g.shape)}")
        if "chunked" in modes:
            d = float((outs["chunked", device][0] - img_g).abs().max())
            log(f"phase 9 slice {name} chunked vs scan on the card: image max|d| {d:.3e}")
            if d != 0.0:
                raise AssertionError(f"phase 9 {name}: chunked and scan differ on the "
                                     f"card: max|d| {d:.3e}")
    for which in DENOISERS:
        outs = {}
        for dev in (device, "cpu"):
            c = denoiser_config(which, False)
            c.noise_model.update(alpha=None, beta=None)
            c.debug = True
            burst = frames.to(dev)
            reset_counts()
            outs[dev] = process_arrays(burst[0], burst[1:], c, iso=100, device=dev)
            if dev == device:
                check_counts(counts(), expected_launches(frames[0], c, n_frames - 1),
                             f"phase 9 slice process_arrays {which}")
        slice_parity(outs[device][0], outs[device][1]["flow"], outs["cpu"][0],
                     outs["cpu"][1]["flow"],
                     f"phase 9 slice process_arrays {which} denoiser")


def phase_switch_cells(frames, device, n_runs=3):
    """Phase 9 (b): on the phase 4 burst, x1.5 (pipeline alone, scan) warm-up
    + ``n_runs`` timed runs; the decimating grey, bilinear and bicubic at x2
    once each; ``process_arrays`` at x2 with each frame-count denoiser once
    (device finishing), and the denoiser alone on its image. Returns
    ``{name: result}``."""
    h, w = frames.shape[1:]
    std, diff = affine_curves()
    snr = burst_snr(frames[0], std)
    res = {"x1.5": run_cell(frames, switch_config((h, w), snr, "x1.5"), "x1.5 scan",
                            device, n_runs, phase=9)}
    res["x1.5"].pop("image")
    curves = (torch.as_tensor(std, device=device), torch.as_tensor(diff, device=device))
    for name in ("decimating", "bilinear", "bicubic"):
        config = switch_config((h, w), snr, name)
        image, dt, got, peak = run_once(
            lambda: make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:],
                                                                *curves),
            lambda: expected_launches(frames[0], config, len(frames) - 1),
            f"phase 9 {name} scan", (2 * h, 2 * w, 3))
        log(f"phase 9 {name} scan x2 (once): {dt:.4f} s, image {tuple(image.shape)}; peak "
            f"memory {peak / 2**30:.3f} GiB; launches {got}; interior finite [{CARD}]")
        check_peak(peak, f"{name} scan", 9)
        res[name] = dict(s=dt, launches=got, peak_bytes=peak)
        del image
    for which, fn in DENOISERS.items():
        pc = denoiser_config(which, True)
        image, dt, got, peak = run_once(
            lambda: process_arrays(frames[0], frames[1:], pc, device=device),
            lambda: expected_launches(frames[0], pc, len(frames) - 1),
            f"phase 9 process_arrays {which}", (2 * h, 2 * w, 3))
        # the denoiser alone, on the finished image and the burst's
        # accumulated robustness (the same work as on the linear image)
        acc_r = process_arrays(frames[0], frames[1:], denoiser_config(which, False),
                               device=device)[1]["accumulated_robustness"]
        dc = dict(pc.accumulated_robustness_denoiser[which], scale=pc.scale)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(image, acc_r, dc)
        torch.cuda.synchronize()
        dn = time.perf_counter() - t0
        log(f"phase 9 process_arrays x2 with the {which} denoiser (once, device "
            f"finishing): {dt:.4f} s, image {tuple(image.shape)}, "
            f"Ts={pc.block_matching.tuning.tile_size}; the denoiser alone {dn:.4f} s; "
            f"peak memory {peak / 2**30:.3f} GiB; launches {got}; interior finite "
            f"[{CARD}]")
        check_peak(peak, f"process_arrays {which}", 9)
        res[which] = dict(s=dt, denoiser_s=dn, launches=got, peak_bytes=peak)
        del image, acc_r
    return res


def phase_accuracy(device):
    """Phase 9 (c): the port's PSNR against ground truth on the card, each
    score within :data:`ACCURACY_TOL_DB` of the JAX scan pipeline's record
    :data:`ACCURACY_SCAN_RECORD`. The truth score and the robustness-off
    scores are also held to :data:`ACCURACY_RECORD`; the robustness-on
    scores are held instead to the port's own scores on the CPU, because
    that record was scored through JAX's CPU default, the ``fused`` slab
    pipeline, whose per-slab refill also fills the interior pixels that
    robustness leaves without any compared frame; the scan pipeline, which
    the port follows, refills the border strips only and scores the ghost
    region lower. Returns ``{score: card dB}``."""
    records = {}
    for name in (ACCURACY_SCAN_RECORD, ACCURACY_RECORD):
        with open(os.path.join(ROOT, name)) as f:
            records[name] = json.load(f)
    truth = score_accuracy.score_truth(device=device)
    rob = score_accuracy.score_robustness(device=device)
    rob_cpu = score_accuracy.score_robustness(device="cpu")
    rows = [("psnr_vs_truth_db (512x512, 20 frames)", truth["psnr_db"],
             {n: r["truth"]["psnr_db"] for n, r in records.items()})]
    for key in ("psnr_ghost_on_db", "psnr_global_on_db", "psnr_ghost_off_db",
                "psnr_global_off_db"):
        held = {n: r["robustness_value"][key] for n, r in records.items()}
        if "_on_" in key:
            held[ACCURACY_RECORD + " (not held)"] = held.pop(ACCURACY_RECORD)
            held["the port on the CPU"] = rob_cpu[key]
        rows.append((f"{key} (384x384 occlusion, 12 frames)", rob[key], held))
    bad = []
    for what, got, held in rows:
        log(f"phase 9 accuracy {what}: card {got:.4f} dB; "
            + "; ".join(f"{n} {v:.4f} dB, difference {got - v:+.4f}"
                        for n, v in held.items()))
        bad += [(what, n) for n, v in held.items()
                if "not held" not in n and not abs(got - v) <= ACCURACY_TOL_DB]
    if bad:
        raise AssertionError(f"phase 9 accuracy: {bad} more than {ACCURACY_TOL_DB} dB "
                             f"from what they are held to")
    return {what: got for what, got, _ in rows}


# ---------------------------------------------------------------------------
# phase 10: the user's entry
# ---------------------------------------------------------------------------

#: the child of phase 10 (b): the port's CLI, then the launches of its
#: kernels and a check that it loaded neither JAX nor the JAX package
RUN_CLI = (
    "import time\n"
    "t0 = time.perf_counter()\n"
    "import json, sys, torch\n"
    "from hmsr_tpu_torch.run_handheld import main\n"
    "from hmsr_tpu_torch.ops import (cuda_ica, cuda_ingest, cuda_merge, cuda_robustness,\n"
    "                                cuda_warp)\n"
    "t1 = time.perf_counter()\n"
    "main()\n"
    "print('TIMES', t1 - t0, time.perf_counter() - t1)\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'hmsr_tpu'))\n"
    "assert not bad, bad\n"
    "print('LAUNCHES ' + json.dumps({'K1': cuda_ica.block_match.launches,\n"
    "    'K2': cuda_ica.ica_steps.launches, 'K3': cuda_ica.ica_fused.launches,\n"
    "    'K4': cuda_warp.upscale_warp.launches, 'K5': cuda_merge.merge_accumulate.launches,\n"
    "    \"K5'\": cuda_merge.merge_burst_accumulate.launches,\n"
    "    'K6': cuda_merge.merge_fused_accumulate.launches,\n"
    "    'K7': cuda_merge.refill_groups.launches,\n"
    "    'K8': cuda_ingest.normalize_bayer.launches, 'K9': cuda_ingest.unpack_raw.launches,\n"
    "    'K10': cuda_robustness.robustness_fused.launches}))\n"
    "print('PEAK', torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0)\n")
#: the finishing routes of phase 10 (c): (tpu.finishing_impl, tonemapping,
#: takes the device chain)
ROUTES = {"auto": ("auto", False, True), "device tonemapping": ("device", True, True),
          "host": ("host", False, False),
          "host tonemapping (smoothstep, no cv2)": ("host", True, False)}
#: the host route each route is held to, at ROUTE_TOL
ROUTE_PAIRS = {"host": "auto", "host tonemapping (smoothstep, no cv2)": "device tonemapping"}
ROUTE_TOL = 1e-5


def verbose_split(text):
    """``{label: ms}`` from the stage times that ``verbose=2`` prints
    (`` -- Device pipeline (align+merge)   :  123.4 milliseconds``)."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^ -- (.+?)\s+:\s+([0-9.]+) milliseconds$", text, re.M)}


def split_text(split):
    return ", ".join(f"{k} {v / 1000:.4f} s" for k, v in split.items())


def png_header(path):
    """``(width, height, bit depth, colour type)`` from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"),
            head[24], head[25])


@contextlib.contextmanager
def without_cv2():
    """``import cv2`` raises ``ImportError`` inside the block (the card's
    machine has no cv2; this makes the route the same on one that has)."""
    saved = sys.modules.get("cv2", False)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is False:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def route_config(impl, tonemap):
    c = configs.default_config()
    c.scale = 2
    c.verbose = 2
    c.postprocessing.do_tonemapping = tonemap
    c["tpu"] = {"finishing_impl": impl}
    return c


def phase_cli(path, out, shape):
    """Phase 10 (b): the CLI in a subprocess on the card. Returns its wall
    and split."""
    env = {k: v for k, v in os.environ.items() if k != "HMSR_FORCE_CPU"}
    cmd = [sys.executable, "-c", RUN_CLI, "--impath", path, "--outpath", out,
           "scale=2", "verbose=2", "robustness.save_mask=True"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 10 CLI exited with {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    got = json.loads(re.search(r"^LAUNCHES (.+)$", res.stdout, re.M).group(1))
    check_counts(got, BRIGHT_LAUNCHES[DEFAULT_FORM], "phase 10 CLI")
    h, w = shape
    for name in (out, out[:-len(".png")] + ".rob.png"):
        if png_header(name) != (2 * w, 2 * h, 8, 2):
            raise AssertionError(f"phase 10 CLI: {name} has IHDR {png_header(name)}, "
                                 f"expected {(2 * w, 2 * h, 8, 2)}")
    split = verbose_split(res.stdout)
    peak = int(re.search(r"^PEAK (\d+)$", res.stdout, re.M).group(1))
    imports, in_main = map(float, re.search(r"^TIMES (\S+) (\S+)$", res.stdout,
                                            re.M).groups())
    if peak > MAX_PEAK_GIB[DEFAULT_FORM] * 2**30:
        raise AssertionError(f"phase 10 CLI: peak memory {peak / 2**30:.3f} GiB > "
                             f"{MAX_PEAK_GIB[DEFAULT_FORM]} GiB")
    log(f"phase 10 (b) CLI split (verbose=2): {split_text(split)} [{CARD}]")
    log(f"phase 10 (b) CLI subprocess: exit 0, wall {wall:.4f} s: imports {imports:.4f} s, "
        f"main() {in_main:.4f} s, the rest interpreter start and exit; launches {got}; "
        f"peak memory {peak / 2**30:.3f} GiB; "
        f"{os.path.basename(out)} {os.path.getsize(out)} B and its .rob.png are "
        f"{2 * w}x{2 * h} 8-bit RGB; no JAX loaded [{CARD}]")
    return dict(wall_s=wall, imports_s=imports, main_s=in_main, split_ms=split,
                launches=got, peak_bytes=peak)


def phase_routes(path, shape, device):
    """Phase 10 (c): ``process`` on the bundle once per finishing route,
    launch counts asserted; the host routes against their device routes."""
    images, res = {}, {}
    for name, (impl, tonemap, on_device) in ROUTES.items():
        config = route_config(impl, tonemap)
        if use_device_finishing(config) != on_device:
            raise AssertionError(f"phase 10 route {name}: wrong finishing chain")
        buf = io.StringIO()
        ctx = without_cv2() if tonemap and not on_device else contextlib.nullcontext()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()        # the burst, earlier images
        reset_counts()
        t0 = time.perf_counter()
        with ctx, contextlib.redirect_stdout(buf):
            image, _ = process(path, config, device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        check_counts(counts(), BRIGHT_LAUNCHES[pipeline_form(config)],
                     f"phase 10 route {name}")
        if peak > MAX_PEAK_GIB[pipeline_form(config)] * 2**30:
            raise AssertionError(f"phase 10 route {name}: peak memory "
                                 f"{peak / 2**30:.3f} GiB")
        check_image(image, (2 * shape[0], 2 * shape[1], 3), f"phase 10 route {name}")
        if image.dtype != torch.float32 or image.device.type != torch.device(device).type:
            raise AssertionError(f"phase 10 route {name}: image {image.dtype} on "
                                 f"{image.device}")
        split = verbose_split(buf.getvalue())
        images[name] = image
        res[name] = dict(s=dt, split_ms=split, peak_bytes=peak)
        log(f"phase 10 (c) process, finishing {name} "
            f"({'device' if on_device else 'host'} chain): {dt:.4f} s; {split_text(split)}; "
            f"peak memory {peak / 2**30:.3f} GiB above what the script held; launches "
            f"those of the {pipeline_form(config)} form [{CARD}]")
    for host, dev in ROUTE_PAIRS.items():
        d = float((images[host] - images[dev]).abs().max())
        log(f"phase 10 (c) {host} against {dev}: max|d| {d:.3e} (held to {ROUTE_TOL})")
        if not d <= ROUTE_TOL:
            raise AssertionError(f"phase 10: the {host} route is {d:.3e} from the {dev} "
                                 f"route")
        res[host]["max_abs_err"] = d
    return res


def phase_graft(device):
    """Phase 10 (d): the graft entry on the card, its launches as its
    configuration implies, against the same entry on the CPU."""
    fn, args = graft_entry.entry(device)
    reset_counts()
    image, _ = fn(*args)
    torch.cuda.synchronize()
    got = counts()
    check_counts(got, expected_launches(args[0], graft_entry.small_config(),
                                        len(args[1])), "phase 10 graft entry")
    check_image(image, (256, 256, 3), "phase 10 graft entry")
    fn_c, args_c = graft_entry.entry("cpu")
    want, _ = fn_c(*args_c)
    d = (image.cpu() - want).abs()[8:-8, 8:-8]
    log(f"phase 10 (d) graft entry: image {tuple(image.shape)}, launches {got}; against "
        f"the CPU: mean|d| {float(d.mean()):.3e}, max|d| {float(d.max()):.3e}")
    if not (float(d.mean()) < 1e-4 and float(d.max()) < 1e-3):
        raise AssertionError("phase 10 graft entry: the card and the CPU disagree")
    return got


def phase_unprocess(device, shape=(3000, 4000), seed=0):
    """Phase 10 (e): the inverse ISP on the card against the CPU with the
    same generators."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    jpg = torch.rand(shape + (3,), generator=g, device=device)
    for _ in range(2):                  # the second call timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw, meta = unprocess_isp(jpg, random.Random(seed), np.random.RandomState(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    want, want_meta = unprocess_isp(jpg.cpu(), random.Random(seed),
                                    np.random.RandomState(seed))
    d = float((raw.cpu() - want).abs().max())
    same = all(np.array_equal(meta[k], v) for k, v in want_meta.items())
    log(f"phase 10 (e) unprocess_isp {tuple(jpg.shape)} float32 on the card: {dt:.4f} s "
        f"(second call, host clock); against the CPU max|d| {d:.3e}; draws equal {same} "
        f"[{CARD}]")
    if not (d <= 1e-6 and same and raw.dtype == torch.float32):
        raise AssertionError("phase 10 unprocess: the card and the CPU disagree")
    return dict(s=dt, max_abs_err=d)


def phase_unpack(device, n_pixels=12_000_000, seed=0):
    """Phase 10 (f): RAW10 and RAW12 unpacking through the user's entry
    (``io.unpack``) on the card, K9, bit for bit against the CPU (its plain
    version). Returns the seconds per format and K9's launches in the
    entry's first call of each format (counts reset just before)."""
    g = torch.Generator()
    g.manual_seed(seed)
    res, launches = {}, 0
    for name, fn, per, nbytes_ in (("RAW10", unpack_raw10, 4, 5),
                                   ("RAW12", unpack_raw12, 2, 3)):
        packed = torch.randint(0, 256, (n_pixels // per * nbytes_,), generator=g,
                               dtype=torch.uint8)
        on_card = packed.to(device)
        torch.cuda.synchronize()
        reset_counts()
        got = fn(on_card, n_pixels)
        torch.cuda.synchronize()
        launches += cuda_ingest.unpack_raw.launches
        if cuda_ingest.unpack_raw.launches != 1:
            raise AssertionError(f"phase 10 unpack {name}: K9 launched "
                                 f"{cuda_ingest.unpack_raw.launches} times, expected 1")
        t0 = time.perf_counter()             # the second call timed
        got = fn(on_card, n_pixels)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = fn(packed, n_pixels)
        same = got.dtype == torch.uint16 and torch.equal(got.cpu().to(torch.int32),
                                                         want.to(torch.int32))
        log(f"phase 10 (f) unpack {name}, {n_pixels} pixels on the card (K9): {dt:.4f} s "
            f"(second call, host clock); equal to the CPU bit for bit: {same} [{CARD}]")
        if not same:
            raise AssertionError(f"phase 10 unpack {name}: the card and the CPU differ")
        res[name] = dt
    res["launches"] = launches
    return res


def phase_entry(frames, device):
    """Phase 10: the user's entry on the card (the module doc's list)."""
    n_frames, h, w = frames.shape
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase10_", dir=os.path.join(ROOT, "build"))
    try:
        path = os.path.join(tmp, "burst.npz")
        t0 = time.perf_counter()
        np.savez(path, frames=frames.cpu().numpy(), cfa=CFA_RGGB,
                 white_balance=np.asarray(WB), iso=100, alpha=ALPHA, beta=BETA)
        log(f"phase 10 (a) burst {n_frames}x{h}x{w} written as {os.path.getsize(path)} B "
            f"(np.savez) in {time.perf_counter() - t0:.4f} s")
        res = {"cli": phase_cli(path, os.path.join(tmp, "out.png"), (h, w))}
        res["routes"] = phase_routes(path, (h, w), device)
    finally:
        shutil.rmtree(tmp)
    res["graft"] = phase_graft(device)
    res["unprocess"] = phase_unprocess(device)
    res["unpack"] = phase_unpack(device)
    return res


# ---------------------------------------------------------------------------
# phase 11: the multi-device path on torch.distributed
# ---------------------------------------------------------------------------

#: band counts of phase 11 (a): ceil(out_h / B) is 188, 94 and 47 at Ts=16,
#: 32 and 64, so that 3 (and 4 at Ts=16) do not divide it
BAND_COUNTS = (2, 3, 4)
#: the meshes of phase 11 (b) on the 512^2 slice, in 4 gloo ranks
SLICE_MESHES = ((2, 2), (4, 1), (1, 4))
FULL_MESH = (2, 2)


def check_banded_merge(device, raw_shape, Ts, rng, variant, time_plain):
    """Phase 11 (a): K5 into 2, 3 and 4 bands (whole tile rows, the
    sharded pipeline's geometry) on random accumulators: the bands,
    concatenated, equal one full launch bit for bit, and each band is within
    1e-5 relative of the banded plain version; each band's device time
    alone beside the full launch's. Returns the rows of the 2-band run (per
    band: ms, plain ms, bound) and the largest error."""
    H, W = raw_shape
    s = 2
    grey, iso = MERGE_VARIANTS[variant]
    n_ch = 1 if grey else 3
    config = burst_config(raw_shape, 40)
    config.mode = "grey" if grey else "bayer"
    comp = torch.as_tensor(np.clip(blocky_scene(rng, H, W, 4) + 0.02 * rng.randn(H, W),
                                   0, 1).astype(np.float32), device=device)
    covs = estimate_kernels(comp, config).contiguous()
    flow = random_flow(rng, H, W, Ts, device)
    r = torch.as_tensor(rng.rand(H, W).astype(np.float32), device=device)
    out_h, out_w = s * H, s * W
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.randint(1 << 30)))
    base = torch.rand((2, n_ch, out_h, out_w), generator=gen, device=device)
    args = (comp, flow, covs, r)
    kw = dict(grey=grey, iso=iso)
    full = base.clone()
    cuda_merge.merge_accumulate(*args, full[0], full[1], CFA_RGGB, Ts, s, **kw)
    scratch = base.clone()
    t_full = timed(lambda: cuda_merge.merge_accumulate(*args, scratch[0], scratch[1],
                                                       CFA_RGGB, Ts, s, **kw))
    del scratch
    frame_bytes = nbytes(comp, flow, r) + (0 if iso else nbytes(covs))
    B = Ts * s
    tag = f"{variant} Ts={Ts} x{s}"
    worst, rows2 = 0.0, []
    for n_bands in BAND_COUNTS:
        rows = -(-(-(-out_h // B)) // n_bands) * B
        bands, times, errs = [], [], []
        for sp in range(n_bands):
            off = sp * rows
            keep = max(0, min(rows, out_h - off))
            band = torch.zeros(2, n_ch, rows, out_w, device=device)
            band[:, :, :keep] = base[:, :, off:off + keep]
            plain = band.clone()
            cuda_merge.merge_accumulate(*args, band[0], band[1], CFA_RGGB, Ts, s, **kw,
                                        row_offset=off)
            cuda_merge.merge_plain(*args, plain[0], plain[1], CFA_RGGB, Ts, s, **kw,
                                   row_offset=off)
            err = max(nan_max_abs(band[k], plain[k])
                      / max(float(plain[k].abs().max()), 1e-30) for k in range(2))
            errs.append(err)
            scratch = band.clone()
            tk = timed(lambda: cuda_merge.merge_accumulate(
                *args, scratch[0], scratch[1], CFA_RGGB, Ts, s, **kw, row_offset=off))
            ms_p = timed(lambda: cuda_merge.merge_plain(
                *args, plain[0], plain[1], CFA_RGGB, Ts, s, **kw, row_offset=off),
                n=1, hold=False).ms if time_plain and n_bands == 2 else float("nan")
            share = keep / out_h
            bnd = bound(2 * nbytes(band[:, :, :keep]) + share * frame_bytes,
                        keep * out_w * merge_flops(iso))
            times.append(tk.ms)
            if n_bands == 2:
                rows2.append(dict(ms=tk.ms, host_us=tk.host_us, plain_ms=ms_p,
                                  bound_ms=bnd[0], bound_by=bnd[1], err=err))
            bands.append(band)
            del scratch, plain
        cat = torch.cat(list(bands), 2)
        same = torch.equal(cat[:, :, :out_h], full) and not cat[:, :, out_h:].any()
        worst = max(worst, *errs)
        log(f"  K5 banded {tag}, {n_bands} bands of {rows} HR rows: against one full "
            f"launch bit-identical: {same}; against the banded plain version rel "
            f"max|d| {max(errs):.3e}; kernel per band "
            + ", ".join(f"{t:.4f}" for t in times)
            + f" ms (sum {sum(times):.4f} ms) against the full launch {t_full.ms:.4f} ms "
            f"[{CARD}]")
        if not same or max(errs) > 1e-5:
            raise AssertionError(f"K5 banded {tag} {n_bands} bands: bit-identical "
                                 f"{same}, relative error {max(errs):.3e}")
        del cat, bands
    return dict(rows2=rows2, err=worst, full_ms=t_full.ms)


def sharded_launches(ref, config, mesh, n_padded):
    """The launches of one rank's run of the sharded pipeline: those of its
    ``n_padded / n_frames`` frames (:func:`expected_launches`), no K5 when
    its band starts past the image."""
    from hmsr_tpu_torch.parallel.sharded import band_geometry, banded_tiled
    expect = expected_launches(ref, scan_config(copy.deepcopy(config)),
                               n_padded // mesh.n_frames)
    rows = band_geometry(config, tuple(ref.shape), mesh.n_space)
    if not banded_tiled(config) or \
            mesh.space * rows >= accum_shape(config, tuple(ref.shape))[1]:
        expect["K5"] = 0
    return expect


def band_counts():
    return cuda_merge.merge_accumulate.band_launches


def slice_config(size=512):
    """The 512^2 slice of phase 11, on the scan form (the single-device
    pipeline its ranks are held against)."""
    config = scan_config(burst_config((size, size), 40, debug=True))
    config.robustness.save_mask = True
    return config


def image_sum(image):
    return float(torch.nan_to_num(image).double().sum())


def sharded_rank(rank, slice_meshes, full_mesh, n_runs):
    """A rank of phase 11 (b) and (c), all on the one card: the 512^2 slice
    on every mesh of ``slice_meshes``, then the 20x12 MP burst on
    ``full_mesh``, warm-up + ``n_runs`` runs. Launch counts checked per run;
    returns what the parent compares (rank 0 its images, every rank their
    sums)."""
    from hmsr_tpu_torch.parallel import make_mesh, make_sharded_pipeline, pad_frames
    import torch.distributed as dist
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    _build.library()
    std, diff = affine_curves()
    out = {"slice": {}}
    frames = make_burst(512, 512, 8, 2, device)
    config = slice_config()
    for shape in slice_meshes:
        mesh = make_mesh(*shape)
        pipe = make_sharded_pipeline(config, CFA_RGGB, WB, mesh, device)
        padded, weights = pad_frames(frames[1:], shape[0])
        torch.cuda.synchronize()
        reset_counts()
        image, acc_r, flows, rmaps = pipe(frames[0], padded, weights, std, diff)
        torch.cuda.synchronize()
        got = counts()
        check_counts(got, sharded_launches(frames[0], config, mesh, len(padded)),
                     f"phase 11 (b) rank {rank} mesh {shape}")
        rec = dict(launches=got, band_launches=band_counts(), comm=pipe.comm,
                   sum=image_sum(image))
        if rank == 0:
            rec.update(image=image.cpu(), acc_r=acc_r.cpu(), flows=flows.cpu())
        out["slice"][shape] = rec
    del frames, padded, image
    frames = make_burst(3000, 4000, 20, 0, device)
    config = scan_config(burst_config((3000, 4000), burst_snr(frames[0], std)))
    ref = frames[0].clone()
    padded, weights = pad_frames(frames[1:], full_mesh[0])
    del frames
    mesh = make_mesh(*full_mesh)
    pipe = make_sharded_pipeline(config, CFA_RGGB, WB, mesh, device)
    expect = sharded_launches(ref, config, mesh, len(padded))
    walls, runs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_runs + 1):
        dist.barrier()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        image, acc_r = pipe(ref, padded, weights, std, diff)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = counts()
        check_counts(got, expect, f"phase 11 (c) rank {rank} run {i}")
        if band_counts() != got["K5"]:
            raise AssertionError(f"phase 11 (c) rank {rank} run {i}: {band_counts()} of "
                                 f"{got['K5']} K5 launches into the band")
        runs.append(dict(launches=got, band_launches=band_counts(), comm=dict(pipe.comm)))
    out["full"] = dict(walls=walls, runs=runs, peak=torch.cuda.max_memory_allocated(),
                       sum=image_sum(image), n_padded=len(padded),
                       frames=(mesh.frame * len(padded) // mesh.n_frames,
                               (mesh.frame + 1) * len(padded) // mesh.n_frames),
                       band=mesh.space)
    if rank == 0:
        out["full"].update(image=image.cpu(), acc_r=acc_r.cpu())
    return out


def nccl_rank(rank):
    """Phase 11 (d), one NCCL rank: the (1, 1) mesh on the 512^2 slice
    against the scan pipeline, and the process layer's broadcast of the
    Monte-Carlo curves on the NCCL group against a draw of its own."""
    import torch.distributed as dist
    from hmsr_tpu_torch.models.process import broadcast_mc_curves
    from hmsr_tpu_torch.noise import run_fast_MC
    from hmsr_tpu_torch.parallel import make_mesh, make_sharded_pipeline, pad_frames
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _build.library()
    std, diff = affine_curves()
    frames = make_burst(512, 512, 8, 2, device)
    config = slice_config()
    mesh = make_mesh(1, 1)
    pipe = make_sharded_pipeline(config, CFA_RGGB, WB, mesh, device)
    torch.cuda.synchronize()
    reset_counts()
    image, acc_r, flows, _ = pipe(frames[0], *pad_frames(frames[1:], 1), std, diff)
    torch.cuda.synchronize()
    got = counts()
    check_counts(got, sharded_launches(frames[0], config, mesh, len(frames) - 1),
                 "phase 11 (d)")
    want, debug = make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:],
                                                              std, diff)
    mc = broadcast_mc_curves(ALPHA, BETA, device)
    mc_want = run_fast_MC(ALPHA, BETA, device=device)
    return dict(backend=dist.get_backend(), launches=got,
                image_equal=torch.equal(torch.nan_to_num(image), torch.nan_to_num(want)),
                max_d=nan_max_abs(image, want),
                acc_equal=torch.equal(acc_r, debug["accumulated_robustness"]),
                flows_equal=torch.equal(flows, debug["flow"]),
                mc_equal=all(np.array_equal(a, b) for a, b in zip(mc, mc_want)))


def phase_sharded(device, full_image):
    """Phase 11 (the module doc's list). ``full_image``: phase 4's image on
    the host. Returns K5's ``banded`` entry of the kernels line."""
    from hmsr_tpu_torch.parallel import spawn_ranks
    t_start = time.perf_counter()
    rng = np.random.RandomState(11)
    log("phase 11 (a) K5 banded against K5 full (3000x4000 x2)")
    banded = {}
    for Ts in (16, 32, 64):
        banded[("bayer-steerable", Ts)] = check_banded_merge(
            device, (3000, 4000), Ts, rng, "bayer-steerable", Ts == MAIN_TS)
    for variant in list(MERGE_VARIANTS)[1:]:
        banded[(variant, MAIN_TS)] = check_banded_merge(device, (3000, 4000), MAIN_TS,
                                                        rng, variant, False)
    torch.cuda.empty_cache()

    # (b) and (c): one spawn of 4 gloo ranks on the card
    std, diff = affine_curves()
    frames = make_burst(512, 512, 8, 2, device)
    config = slice_config()
    want, want_dbg = make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:],
                                                                 std, diff)
    want, want_acc, want_flow = want.cpu(), want_dbg["accumulated_robustness"].cpu(), \
        want_dbg["flow"].cpu()
    del frames, want_dbg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks(sharded_rank, 4, args=(SLICE_MESHES, FULL_MESH, 3), backend="gloo",
                      threads=2)
    log(f"phase 11 (b)+(c) 4 gloo ranks on one card: spawn to last result "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    n_cmp = 7
    for shape in SLICE_MESHES:
        r0 = res[0]["slice"][shape]
        d_img = (r0["image"] - want).abs()[8:-8, 8:-8]
        par = dict(flow_max=float((r0["flows"][:n_cmp] - want_flow).abs().max()),
                   img_mean=float(d_img.mean()), img_max=float(d_img.max()))
        d_acc = float((r0["acc_r"] - want_acc).abs().max())
        sums = {r["slice"][shape]["sum"] for r in res}
        log(f"phase 11 (b) mesh {shape}: flow max|d| {par['flow_max']:.3e}, image "
            f"mean|d| {par['img_mean']:.3e} max|d| {par['img_max']:.3e}, acc_r max|d| "
            f"{d_acc:.3e}; every rank's image the same: {len(sums) == 1}; launches per "
            "rank " + "; ".join(f"{i}: {r['slice'][shape]['launches']} (K5 into a band "
                                f"{r['slice'][shape]['band_launches']})"
                                for i, r in enumerate(res))
            + f"; rank 0's collectives {r0['comm']}")
        if not (par["flow_max"] < 1e-2 and par["img_mean"] < 1e-4 and par["img_max"] < 1e-3
                and d_acc <= 1e-5 and len(sums) == 1):
            raise AssertionError(f"phase 11 (b) mesh {shape}: {par}, acc_r max|d| "
                                 f"{d_acc:.3e}, image sums {sums}")
    full = [r["full"] for r in res]
    d_img = (full[0]["image"] - full_image).abs()[8:-8, 8:-8]
    d_mean, d_max = float(d_img.mean()), float(d_img.max())
    sums = {f["sum"] for f in full}
    for i, f in enumerate(full):
        timed_walls = f["walls"][1:]
        log(f"phase 11 (c) rank {i} (frames {f['frames'][0]}..{f['frames'][1] - 1} of "
            f"{f['n_padded']} padded, band {f['band']}): walls warm-up "
            f"{f['walls'][0]:.4f} s, timed " + ", ".join(f"{w:.4f}" for w in timed_walls)
            + f" s (median {statistics.median(timed_walls):.4f} s); peak memory "
            f"{f['peak'] / 2**30:.3f} GiB; launches per run {f['runs'][-1]['launches']} "
            f"(K5 into a band {f['runs'][-1]['band_launches']}); collectives "
            f"{f['runs'][-1]['comm']} [{CARD}; one card time-sliced between 4 "
            "processes: no scaling over cards]")
    log(f"phase 11 (c) mesh {FULL_MESH} image against phase 4's single-device image: "
        f"interior mean|d| {d_mean:.3e} max|d| {d_max:.3e}; every rank's image the "
        f"same: {len(sums) == 1}")
    if not (d_mean < 1e-4 and d_max < 1e-3) or len(sums) != 1:
        raise AssertionError(f"phase 11 (c): mean|d| {d_mean:.3e}, max|d| {d_max:.3e}, "
                             f"image sums {sums}")
    del res

    # (d) NCCL at world size 1
    nc = spawn_ranks(nccl_rank, 1, backend="nccl")[0]
    log(f"phase 11 (d) {nc['backend']} world size 1, mesh (1, 1) on the slice: image "
        f"equal to the scan pipeline's {nc['image_equal']} (max|d| {nc['max_d']:.3e}), "
        f"acc_r equal {nc['acc_equal']}, flows equal {nc['flows_equal']}; launches "
        f"{nc['launches']}; Monte-Carlo curves broadcast on the NCCL group equal to "
        f"a draw of their own {nc['mc_equal']}")
    if not (nc["backend"] == "nccl" and nc["image_equal"] and nc["acc_equal"]
            and nc["flows_equal"] and nc["mc_equal"]):
        raise AssertionError(f"phase 11 (d): {nc}")

    # (e) the dry run
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4, device="cuda", backend="gloo")
    log(f"phase 11 (e) graft_entry.dryrun_multichip(4) over gloo on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 11 took {time.perf_counter() - t_start:.1f} s [{CARD}]")

    main = banded[("bayer-steerable", MAIN_TS)]
    per_band = main["rows2"]
    return {
        "name": "K5 banded branch (accumulators of a band of tile rows at row_offset)",
        "route": "cuda", "source": "hmsr_tpu_torch/csrc/merge.cu",
        "replaces": "hmsr_tpu/ops/pallas_merge.py:382",
        "launches": full[0]["runs"][-1]["band_launches"],
        "launches_in": f"rank 0 of the {FULL_MESH} full-size run (phase 11 (c)), per run; "
                       "every rank: " + ", ".join(str(f["runs"][-1]["band_launches"])
                                                   for f in full),
        "max_abs_err": max(b["err"] for b in banded.values()),
        "ms": sum(b["ms"] for b in per_band), "host_us": sum(b["host_us"] for b in per_band),
        "ms_per_band": [b["ms"] for b in per_band],
        "full_launch_ms": main["full_ms"],
        "plain_ms": sum(b["plain_ms"] for b in per_band),
        "bound_ms": sum(b["bound_ms"] for b in per_band),
        "bound_by": max(per_band, key=lambda b: b["bound_ms"])["bound_by"],
        "library_ms": None}


# ---------------------------------------------------------------------------
# phase 12: the fused and vmapped forms
# ---------------------------------------------------------------------------

#: (Ts, scale, variant, denoiser) of phase 12 (a): 19 compared frames of
#: 3000x4000, then F_SMALL frames of 1024x1024
FUSED_MAIN_CASES = [(16, 2, "bayer-steerable", False), (32, 2, "bayer-steerable", False),
                    (64, 2, "bayer-steerable", False), (16, 2, "grey-steerable", False),
                    (16, 2, "bayer-iso", False), (16, 2, "grey-iso", False),
                    (16, 2, "bayer-steerable", True)]
FUSED_SMALL_CASES = [(16, s, v, False) for s in (1, 3) for v in MERGE_VARIANTS] + \
    [(16, 3, "bayer-steerable", True)]
F_MAIN, F_SMALL = 19, 5
#: the 512^2 slice's variants of phase 12 (b): (grey, iso, denoiser)
FUSED_SLICE_VARIANTS = {"bayer-steerable": (False, False, False),
                        "grey-steerable": (True, False, False),
                        "bayer-iso": (False, True, False),
                        "bayer-steerable denoiser": (False, False, True)}
#: the fused and vmapped forms: tpu.pipeline and tpu.fused_impl
FORMS = {"fused slab": ("fused", "slab"), "fused tiled": ("fused", "tiled"),
         "vmapped": ("vmapped", "slab")}


def ref_merge_flops(iso, rr, denoise):
    """Float operations of the reference merge at one HR pixel: per tap of
    the (2 rr + 1)^2 window the exponent (8 steerable, 4 iso; one more
    division with the denoiser), 1 exp, 2 for the weight, 2 to accumulate;
    25 for the steerable covariance interpolation and the guarded inverse."""
    return (2 * rr + 1) ** 2 * ((4 if iso else 8) + 5 + int(denoise)) + \
        (0 if iso else 25)


def denoiser_kwargs(config, acc_rob):
    m = config.accumulated_robustness_denoiser.merge
    return dict(acc_rob=acc_rob, rad_max=int(m.rad_max),
                max_multiplier=float(m.max_multiplier),
                max_frame_count=float(m.max_frame_count))


def card_scenes(gen, n, shape, device, block=4):
    """``n`` blocky scenes with 2 % noise, (n, H, W) in [0, 1], made on the
    card from the generator ``gen`` (``blocky_scene``'s kind, without the
    host's time)."""
    H, W = shape
    base = torch.rand((n, H // block + 1, W // block + 1), generator=gen, device=device)
    scene = base.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :H, :W]
    noise = torch.randn((n, H, W), generator=gen, device=device)
    return (scene + 0.02 * noise).clamp(0, 1).contiguous()


def check_fused_kernel(device, raw_shape, Ts, s, variant, denoise, F, rng, gen, ptxas,
                       refill=False):
    """K6 on F frames and the reference against its plain version (1e-5
    relative), and against K5' over the same frames into zeros followed by
    the plain reference merge (1e-5 relative, on the image's rows and
    columns); timed. Frames, robustness and the accumulated robustness are
    drawn on the card from ``gen``, the flows from ``rng``. With ``refill``,
    K7 on these real accumulators too (:func:`check_refill_real`): per slab
    on K6's, in the image layout on K5''s with the reference merge (the
    scan forms' accumulators), and per tile on K6's. Returns the row, K7's
    rows under ``refill_rows``."""
    H, W = raw_shape
    grey, iso = MERGE_VARIANTS[variant]
    config = burst_config(raw_shape, 40)
    config.mode = "grey" if grey else "bayer"
    scenes = card_scenes(gen, F + 1, raw_shape, device)
    ref, comp = scenes[0], scenes[1:]
    covs = torch.stack([estimate_kernels(c, config) for c in comp]).contiguous()
    ref_covs = estimate_kernels(ref, config).contiguous()
    flows = random_flow(rng, H, W, Ts, device, lead=(F,))
    r = torch.rand((F, H, W), generator=gen, device=device)
    dn = {}
    if denoise:
        acc = torch.rand((H, W), generator=gen, device=device) * ((F + 1) * 0.4)
        dn = denoiser_kwargs(config, acc)
    args = (comp, flows, covs, r, ref, ref_covs, CFA_RGGB, Ts, s)
    kw = dict(grey=grey, iso=iso, **dn)
    n_k, d_k = cuda_merge.merge_fused_accumulate(*args, **kw)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    n_p, d_p = cuda_merge.merge_fused_plain(*args, **kw)
    t1.record()
    torch.cuda.synchronize()
    ms_p = t0.elapsed_time(t1)
    err_n = nan_max_abs(n_k, n_p) / float(n_p.abs().max())
    err_d = nan_max_abs(d_k, d_p) / float(d_p.abs().max())
    err = max(nan_max_abs(n_k, n_p), nan_max_abs(d_k, d_p))
    # K7 refills where den <= STARVED_DEN: the pixels where K6 and its plain
    # version fall on either side of that threshold
    flips = int(((d_k > STARVED_DEN) != (d_p > STARVED_DEN)).sum())
    starved, n_values = int((d_p <= STARVED_DEN).sum()), d_p.numel()
    del n_p, d_p
    n_ch = 1 if grey else 3
    n_s = torch.zeros((n_ch, s * H, s * W), device=device)
    d_s = torch.zeros_like(n_s)
    cuda_merge.merge_burst_accumulate(comp, flows, covs, r, n_s, d_s, CFA_RGGB, Ts, s,
                                      grey, iso)
    cuda_merge.merge_ref_plain(ref, ref_covs, n_s, d_s, CFA_RGGB, s, grey, iso, **dn)
    err_sn = nan_max_abs(n_k[:, :s * H, :s * W], n_s) / float(n_s.abs().max())
    err_sd = nan_max_abs(d_k[:, :s * H, :s * W], d_s) / float(d_s.abs().max())
    refill_rows = []
    if refill:
        B, grid = Ts * s, (s * H, s * W)
        refill_rows = [
            check_refill_real("slab", "K6's accumulators (the fused form)", n_k, d_k,
                              lambda: cuda_merge.refill_groups(n_k, d_k, B, *grid),
                              lambda: cuda_merge.refill_plain(n_k, d_k, B, *grid), ptxas),
            check_refill_real("image", "K5' and the reference merge's (the scan forms)",
                              n_s, d_s,
                              lambda: cuda_merge.refill_image(n_s, d_s, REFILL_BORDER),
                              lambda: normalize_accum(n_s, d_s,
                                                      refill_border=REFILL_BORDER), ptxas),
            check_refill_real("tile", "K6's accumulators (fused_impl: tiled)", n_k, d_k,
                              lambda: cuda_merge.refill_groups(n_k, d_k, B, *grid, True),
                              lambda: cuda_merge.refill_plain(n_k, d_k, B, *grid, True),
                              ptxas)]
    del n_s, d_s, n_k, d_k
    tk = timed(lambda: cuda_merge.merge_fused_accumulate(*args, **kw))
    rr = int(dn["rad_max"]) if denoise else 1
    shape = cuda_merge.fused_accum_shape(raw_shape, Ts, s, grey)
    hr_px = shape[1] * shape[2]
    in_bytes = nbytes(comp, flows, r, ref) + (0 if iso else nbytes(covs, ref_covs)) + \
        (nbytes(dn["acc_rob"]) if denoise else 0)
    bnd = bound(in_bytes + 2 * 4 * n_ch * hr_px,
                hr_px * (F * merge_flops(iso) + ref_merge_flops(iso, rr, denoise)))
    inst = merge_instance(FUSED_KERNEL, grey, iso)
    regs = ptxas[inst]
    tag = (f"{variant}{' denoiser' if denoise else ''} Ts={Ts} x{s}, {F} frames of "
           f"{(H, W)} -> {shape}")
    log(f"  K6 {tag}: rel max|d| against its plain version num {err_n:.3e} den "
        f"{err_d:.3e}; against K5' + reference merge num {err_sn:.3e} den "
        f"{err_sd:.3e}; den > {STARVED_DEN} decided otherwise than the plain version "
        f"at {flips} of {n_values} values ({starved} starved in the plain version); "
        f"{time_text(tk)}, plain {ms_p:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); {inst} {regs['registers']} registers, spills "
        f"{regs['spill_stores']}/{regs['spill_loads']} B [{CARD}]")
    if not max(err_n, err_d, err_sn, err_sd) <= 1e-5:
        raise AssertionError(f"K6 {tag}: relative errors {err_n:.3e} / {err_d:.3e} "
                             f"against the plain version, {err_sn:.3e} / {err_sd:.3e} "
                             f"against K5' + the reference merge")
    return dict(Ts=Ts, s=s, variant=variant, denoise=denoise, frames=F, err=err,
                rel_err=max(err_n, err_d, err_sn, err_sd), starved_flips=flips,
                ms=tk.ms, host_us=tk.host_us, plain_ms=ms_p, bound_ms=bnd[0],
                bound_by=bnd[1], registers=regs["registers"], refill_rows=refill_rows)


def phase_fused_kernel(device, ptxas, seed=12):
    """Phase 12 (a), K6's part (and K7 on the main case's accumulators).
    Returns the rows of every case."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device).manual_seed(seed)
    rows = [check_fused_kernel(device, (3000, 4000), Ts, s, v, dn, F_MAIN, rng, gen,
                               ptxas, refill=i == 0)
            for i, (Ts, s, v, dn) in enumerate(FUSED_MAIN_CASES)]
    rows += [check_fused_kernel(device, (1024, 1024), Ts, s, v, dn, F_SMALL, rng, gen,
                                ptxas) for Ts, s, v, dn in FUSED_SMALL_CASES]
    return rows


#: (Ts, scale, grey, tiles, raw shape) of K7's cases per group in phase 12
#: (a), on the stress input: the main path's accumulators first
REFILL_CASES = [(16, 2, False, False, (3000, 4000)), (16, 2, False, True, (3000, 4000)),
                (32, 2, False, False, (3000, 4000)), (32, 2, False, True, (3000, 4000)),
                (64, 2, False, False, (3000, 4000)), (64, 2, False, True, (3000, 4000)),
                (16, 2, True, False, (3000, 4000)), (16, 1, False, False, (1024, 1024)),
                (16, 1, False, True, (1024, 1024)), (16, 3, False, False, (1024, 1024)),
                (16, 3, False, True, (1024, 1024))]
#: (name, (c, H, W)) of K7's image-layout cases in phase 12 (a): the scan
#: forms' accumulators of the bright, grey, x3 and x1.5 cells, 1024^2 as
#: every other plane of a taller buffer (the sharded pipeline's view, no
#: copy), and a side under 2 (32 + 8) with a width no multiple of 4 (the
#: refill everywhere; scalar loads and stores)
IMAGE_CASES = [("bright", (3, 6000, 8000)), ("grey", (1, 6000, 8000)),
               ("x3", (3, 9000, 12000)), ("x1.5", (3, 4500, 6000)),
               ("1024^2 strided planes", (3, 1024, 1024)), ("under 2M", (3, 60, 75))]
#: K7's output pieces (rows, columns): the slow path's unit
REFILL_PIECE = (32, 64)


def slow_pieces(starved):
    """The K7 pieces (:data:`REFILL_PIECE`, from the origin: those of the
    image layout, and of the slab layout where B is a multiple of their 32
    rows) that hold a True of the (c, h, w) mask ``starved``, and all
    pieces."""
    pr, pc = REFILL_PIECE
    c, h, w = starved.shape
    m = torch.zeros((c, -(-h // pr) * pr, -(-w // pc) * pc), dtype=torch.bool,
                    device=starved.device)
    m[:, :h, :w] = starved
    m = m.reshape(c, m.shape[1] // pr, pr, m.shape[2] // pc, pc).any(4).any(2)
    return int(m.sum()), m.numel()


def border_region(h, w, device, border=REFILL_BORDER):
    """The (h, w) mask of the pixels within ``border`` of an edge."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    return ((ys < border) | (ys >= h - border))[:, None] | \
        ((xs < border) | (xs >= w - border))[None, :]


def refill_row(layout, what, num, den, out_k, out_p, ms_p, tk, slow, ptxas):
    """Log one K7 case and gate it (max|d| 0, NaN where the plain version
    has NaN); the row. ``slow``: (pieces taking the slow path, pieces), or
    None where the pieces do not tile from the origin."""
    err = nan_max_abs(out_k, out_p)
    bnd = bound(3 * nbytes(out_k), 0)    # num and den at each output value, the image
    regs = ptxas[REFILL_KERNEL]
    n_starved = int((~(den > STARVED_DEN)).sum())
    pieces = "" if slow is None else f"; {slow[0]} of {slow[1]} pieces on the slow path"
    log(f"  K7 {layout} {what}, {tuple(num.shape)} -> {tuple(out_k.shape)}: max|d| "
        f"against its plain version {err:.3e} ({n_starved} starved values{pieces}); "
        f"{time_text(tk)}, plain {ms_p:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}); {REFILL_KERNEL} {regs['registers']} "
        f"registers, spills {regs['spill_stores']}/{regs['spill_loads']} B [{CARD}]")
    if err != 0.0:
        raise AssertionError(f"K7 {layout} {what}: max|d| {err:.3e} against its plain "
                             f"version")
    return dict(layout=layout, what=what, shape=list(num.shape), err=err, ms=tk.ms,
                host_us=tk.host_us, plain_ms=ms_p, bound_ms=bnd[0], bound_by=bnd[1],
                slow_pieces=slow and slow[0], pieces=slow and slow[1])


def plain_ms(fn):
    """``fn()`` once between CUDA events: (its result, ms)."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def check_refill_real(layout, what, num, den, kernel, plain, ptxas):
    """K7 (``kernel()``, in ``layout``) on real accumulators against
    ``plain()`` bit for bit; timed."""
    out_k = kernel()
    out_p, ms_p = plain_ms(plain)
    h, w = out_k.shape[1:]
    starved = ~(den[:, :h, :w] > STARVED_DEN)
    if layout == "image":
        starved &= border_region(h, w, den.device)
    row = refill_row(layout, what, num, den, out_k, out_p, ms_p, timed(kernel),
                     None if layout == "tile" else slow_pieces(starved), ptxas)
    row["input"] = "real"
    return row


def check_refill_kernel(device, Ts, s, grey, tiles, raw_shape, gen, ptxas):
    """K7 per group against its plain version (``normalize_groups`` and the
    crop) on the card, bit for bit, on :func:`starved_accumulators` at K6's
    padded geometry; timed. Returns the row."""
    H, W = raw_shape
    B = Ts * s
    shape = cuda_merge.fused_accum_shape(raw_shape, Ts, s, grey)
    num, den = starved_accumulators(gen, shape, device)
    args = (num, den, B, H * s, W * s, tiles)
    out_k = cuda_merge.refill_groups(*args)
    out_p, ms_p = plain_ms(lambda: cuda_merge.refill_plain(*args))
    what = f"{'grey' if grey else 'Bayer'} Ts={Ts} x{s} of B={B}"
    slow = slow_pieces(~(den[:, :H * s, :W * s] > STARVED_DEN)) \
        if B % REFILL_PIECE[0] == 0 and not tiles else None
    row = refill_row("tile" if tiles else "slab", what, num, den, out_k, out_p, ms_p,
                     timed(lambda: cuda_merge.refill_groups(*args)), slow, ptxas)
    row.update(Ts=Ts, s=s, grey=grey, tiles=tiles, input="stress")
    return row


def check_refill_image(device, what, shape, gen, ptxas):
    """K7's image layout against ``normalize_accum(refill_border=32)`` on
    the card, bit for bit, on :func:`edge_starved_accumulators`; timed.
    Returns the row."""
    num, den = edge_starved_accumulators(gen, shape, device, strided="strided" in what)
    out_k = cuda_merge.refill_image(num, den, REFILL_BORDER)
    out_p, ms_p = plain_ms(lambda: normalize_accum(num, den, refill_border=REFILL_BORDER))
    starved = ~(den > STARVED_DEN)
    if min(shape[1:]) > 2 * (REFILL_BORDER + 8):
        starved &= border_region(*shape[1:], device)
    row = refill_row("image", what, num, den, out_k, out_p, ms_p,
                     timed(lambda: cuda_merge.refill_image(num, den, REFILL_BORDER)),
                     slow_pieces(starved), ptxas)
    row["input"] = "edge-starved"
    return row


def phase_refill_kernel(device, ptxas, seed=13):
    """Phase 12 (a), K7's part: per group on the stress input, then the
    image layout. Returns (the per-group rows, the image rows)."""
    gen = torch.Generator(device).manual_seed(seed)
    groups = [check_refill_kernel(device, Ts, s, grey, tiles, shape, gen, ptxas)
              for Ts, s, grey, tiles, shape in REFILL_CASES]
    images = [check_refill_image(device, what, shape, gen, ptxas)
              for what, shape in IMAGE_CASES]
    return groups, images


def scan_config(config):
    """``config`` pinned to the scan form (``tpu.pipeline: scan``; the
    default ``auto`` runs :data:`DEFAULT_FORM`), for the phases that hold
    the scan path and its records."""
    config["tpu"] = {"pipeline": "scan"}
    return config


def form_config(config, form):
    config = copy.deepcopy(config)
    config["tpu"] = {"pipeline": FORMS[form][0], "fused_impl": FORMS[form][1]}
    return config


def phase_fused_slice(device, size=512, n_frames=8, seed=2):
    """Phase 12 (b): the slice in the fused (slab, tiled) and vmapped forms
    on the card against the same forms on the CPU (phase 3's bounds), in
    each of :data:`FUSED_SLICE_VARIANTS`, launch counts asserted; vmapped
    against the card's scan within the same bounds; fused at x1.5 equal to
    scan. Returns ``{variant: K6 launches of its fused slab run}``."""
    frames = make_burst(size, size, n_frames, seed, device)
    std, diff = affine_curves()
    k6 = {}
    for variant, (grey, iso, denoise) in FUSED_SLICE_VARIANTS.items():
        base = scan_config(burst_config((size, size), 40, debug=True))
        base.mode = "grey" if grey else "bayer"
        base.merging.kernel = "iso" if iso else "steerable"
        base.accumulated_robustness_denoiser.enabled = denoise
        scan = make_pipeline(base, CFA_RGGB, WB, device)(frames[0], frames[1:], std, diff)
        for form in FORMS:
            config = form_config(base, form)
            outs = {}
            for dev in (device, "cpu"):
                burst = frames.to(dev)
                reset_counts()
                outs[dev] = make_pipeline(config, CFA_RGGB, WB, dev)(burst[0], burst[1:],
                                                                    std, diff)
                if dev == device:
                    got = counts()
                    check_counts(got, expected_launches(frames[0], config, n_frames - 1),
                                 f"phase 12 slice {variant} {form}")
                    if form == "fused slab":
                        k6[variant] = got["K6"]
            slice_parity(outs[device][0], outs[device][1]["flow"], outs["cpu"][0],
                         outs["cpu"][1]["flow"], f"phase 12 slice {variant} {form}")
            if form == "vmapped":
                slice_parity(outs[device][0], outs[device][1]["flow"], scan[0].cpu(),
                             scan[1]["flow"].cpu(),
                             f"phase 12 slice {variant} vmapped against scan on the card")
    config = switch_config((size, size), 40, "x1.5", debug=True)
    img_s, _ = make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:], std,
                                                           diff)
    config = form_config(config, "fused slab")
    reset_counts()
    img_f, _ = make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:], std,
                                                           diff)
    check_counts(counts(), expected_launches(frames[0], config, n_frames - 1),
                 "phase 12 slice x1.5 fused")
    d = float((img_f - img_s).abs().max())
    log(f"phase 12 slice x1.5 fused against scan on the card: image max|d| {d:.3e}")
    if d != 0.0:
        raise AssertionError(f"phase 12: fused at x1.5 differs from scan ({d:.3e})")
    return k6


def phase_fused_full(frames, device, scan_image, n_runs=3):
    """Phase 12 (c): the bright burst in the fused form (pipeline alone,
    warm-up + ``n_runs`` timed runs, then ``process_arrays`` once), x3 with
    the denoiser in the fused form once, and the vmapped form once; launch
    counts, shapes, finite interiors and peaks; the fused image against the
    scan image of phase 4 (printed: they differ where the per-slab refill
    fills starved pixels), the vmapped image against it (phase 3's
    bounds). Returns the fused run's result."""
    h, w = frames.shape[1:]
    std, diff = affine_curves()
    snr = burst_snr(frames[0], std)
    curves = (torch.as_tensor(std, device=device), torch.as_tensor(diff, device=device))
    config = form_config(burst_config((h, w), snr), "fused slab")
    pipe = make_pipeline(config, CFA_RGGB, WB, device)
    torch.cuda.reset_peak_memory_stats()
    image, _, times, launches, warm = run_timed(
        lambda: pipe(frames[0], frames[1:], *curves), n_runs,
        lambda: expected_launches(frames[0], config, len(frames) - 1), "phase 12 fused",
        device)
    check_counts(launches, BRIGHT_LAUNCHES["fused"], "phase 12 fused")
    check_image(image, (2 * h, 2 * w, 3), "phase 12 fused")
    peak = torch.cuda.max_memory_allocated()
    d = (image.cpu() - scan_image).abs()[8:-8, 8:-8]
    res = dict(min_s=min(times), median_s=statistics.median(times), warm_s=warm,
               launches=launches, peak_bytes=peak)
    log(f"phase 12 fused {len(frames)}x{h}x{w} x2: warm-up {warm:.4f} s, min "
        f"{res['min_s']:.4f} s, median {res['median_s']:.4f} s of {n_runs}; peak memory "
        f"{peak / 2**30:.3f} GiB; launches per run {launches}; against phase 4's scan "
        f"image mean|d| {float(d.mean()):.3e}, max|d| {float(d.max()):.3e}, "
        f"{int((d > 1e-3).sum())} values above 1e-3 [{CARD}]")
    if peak > MAX_PEAK_GIB["fused"] * 2**30:
        raise AssertionError(f"phase 12 fused: peak memory {peak / 2**30:.3f} GiB > "
                             f"{MAX_PEAK_GIB['fused']} GiB")
    del image, d
    pc = process_config("fused")
    image, dt, got, peak = run_once(
        lambda: process_arrays(frames[0], frames[1:], pc, device=device),
        lambda: expected_launches(frames[0], pc, len(frames) - 1),
        "phase 12 process_arrays fused", (2 * h, 2 * w, 3))
    log(f"phase 12 process_arrays fused (once, device finishing): {dt:.4f} s, "
        f"Ts={pc.block_matching.tuning.tile_size}; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {got} [{CARD}]")
    if peak > MAX_PEAK_GIB["fused"] * 2**30:
        raise AssertionError(f"phase 12 process_arrays fused: peak memory "
                             f"{peak / 2**30:.3f} GiB > {MAX_PEAK_GIB['fused']} GiB")
    res.update(process_s=dt, process_peak_bytes=peak)
    del image
    config = burst_config((h, w), snr)
    BENCH_CELLS["x3"](config)
    config = form_config(config, "fused slab")
    image, dt, got, peak = run_once(
        lambda: make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:],
                                                            *curves),
        lambda: expected_launches(frames[0], config, len(frames) - 1),
        "phase 12 x3 fused", (3 * h, 3 * w, 3))
    log(f"phase 12 x3 fused (once, the denoiser in K6): {dt:.4f} s, image "
        f"{tuple(image.shape)}; peak memory {peak / 2**30:.3f} GiB; launches {got} "
        f"[{CARD}]")
    check_peak(peak, "x3 fused", 12)
    res.update(x3_s=dt, x3_peak_bytes=peak)
    del image
    config = form_config(burst_config((h, w), snr), "vmapped")
    image, dt, got, peak = run_once(
        lambda: make_pipeline(config, CFA_RGGB, WB, device)(frames[0], frames[1:],
                                                            *curves),
        lambda: expected_launches(frames[0], config, len(frames) - 1),
        "phase 12 vmapped", (2 * h, 2 * w, 3))
    d = (image.cpu() - scan_image).abs()[8:-8, 8:-8]
    log(f"phase 12 vmapped (once): {dt:.4f} s; peak memory {peak / 2**30:.3f} GiB; "
        f"launches {got}; against phase 4's scan image mean|d| {float(d.mean()):.3e}, "
        f"max|d| {float(d.max()):.3e} [{CARD}]")
    check_peak(peak, "vmapped", 12)
    if not (float(d.mean()) < 1e-4 and float(d.max()) < 1e-3):
        raise AssertionError(f"phase 12 vmapped against scan: mean|d| {float(d.mean())}, "
                             f"max|d| {float(d.max())}")
    res.update(vmapped_s=dt, vmapped_peak_bytes=peak, vmapped_launches=got)
    return res


def phase_fused_accuracy(device):
    """Phase 12 (d): the fused form's PSNR against ground truth on the card,
    each of the five scores within :data:`ACCURACY_TOL_DB` of
    :data:`ACCURACY_RECORD`, which the JAX package scored through the same
    form. Returns ``{score: card dB}``."""
    with open(os.path.join(ROOT, ACCURACY_RECORD)) as f:
        record = json.load(f)
    truth = score_accuracy.score_truth(device=device, pipeline="fused")
    rob = score_accuracy.score_robustness(device=device, pipeline="fused")
    rows = [("psnr_vs_truth_db", truth["psnr_db"], record["truth"]["psnr_db"])]
    rows += [(key, rob[key], record["robustness_value"][key])
             for key in ("psnr_ghost_on_db", "psnr_global_on_db", "psnr_ghost_off_db",
                         "psnr_global_off_db")]
    for key, got, want in rows:
        log(f"phase 12 accuracy fused {key}: card {got:.4f} dB; {ACCURACY_RECORD} "
            f"{want:.4f} dB, difference {got - want:+.4f}")
    bad = [key for key, got, want in rows if not abs(got - want) <= ACCURACY_TOL_DB]
    if bad:
        raise AssertionError(f"phase 12 accuracy: {bad} more than {ACCURACY_TOL_DB} dB "
                             f"from {ACCURACY_RECORD}")
    return {key: got for key, got, _ in rows}


# ---------------------------------------------------------------------------
# phase 13: raw ingestion
# ---------------------------------------------------------------------------

#: the CFA layouts of phase 13 (a), as the loaders leave them (greens 1)
CFA_LAYOUTS = {"RGGB": (0, 1, 1, 2), "BGGR": (2, 1, 1, 0), "GRBG": (1, 0, 2, 1),
               "GBRG": (1, 2, 0, 1)}
INGEST_WHITES = (1023, 4095, 65535)
INGEST_WB = (1.9, 1.0, 1.4, 1.0)
#: the DNG burst of phase 13 (c): 10 bits over a black level of 64
DNG_BLACK, DNG_WHITE = 64, 1023


def random_u16(gen, shape, device):
    """uint16 over the whole range, 0 to 65535, from ``gen``."""
    return torch.randint(0, 65536, shape, generator=gen, device=device,
                         dtype=torch.int32).to(torch.uint16)


def same_bits(a, b):
    """Equal bit for bit (float32 as int32, uint16 as int16)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(view),
                                                                      b.view(view))


def check_normalize(frames, layout, white, what):
    """K8 on ``frames`` against its plain version on the card, bit for bit,
    blacks above many of the values; returns (args, max|d|)."""
    blacks = [white // 16, white // 20, white // 12, white // 20]
    args = native_loader.normalization(CFA_LAYOUTS[layout], blacks, white, INGEST_WB)
    out_k = cuda_ingest.normalize_bayer(frames, *args)
    out_p = cuda_ingest.normalize_bayer_plain(frames, *args)
    torch.cuda.synchronize()
    if not same_bits(out_k, out_p):
        raise AssertionError(f"phase 13 K8 {what} {layout} white {white}: max|d| "
                             f"{float((out_k - out_p).abs().max()):.3e}, not bit for bit")
    return args, float((out_k - out_p).abs().max())


def time_upload(host, device, n=2):
    """Seconds of the fastest of ``n`` host-to-card copies of the numpy
    array ``host`` (pageable memory, as the loader's), synchronised."""
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.from_numpy(host).to(device)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phase_normalize(device, shape=(20, 3000, 4000), seed=13):
    """Phase 13 (a): K8 against its plain version on the card, bit for bit:
    the 20x3000x4000 stack of random uint16 (0 to 65535) in the four CFA
    layouts at white levels 1023, 4095 and 65535, odd shapes (3001x4003,
    7x9) and bases 2, 6 and 8 bytes off 16-byte alignment; the main case
    (RGGB, 10 bits) timed beside its plain version, its bound and the
    uint16 upload beside the float32 upload it replaces. Returns the row of
    the ``kernels`` line."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    frames = random_u16(g, shape, device)
    errs = [check_normalize(frames, layout, white, "20x3000x4000")[1]
            for layout in CFA_LAYOUTS for white in INGEST_WHITES]
    flat = frames.reshape(-1)
    for what, off, sub in (("2x3001x4003", 0, (2, 3001, 4003)), ("3x7x9", 0, (3, 7, 9)),
                           ("4x3000x4000 base +2 B", 1, (4, 3000, 4000)),
                           ("4x3000x4000 base +6 B", 3, (4, 3000, 4000)),
                           ("4x3000x4000 base +8 B", 4, (4, 3000, 4000))):
        view = flat[off:off + sub[0] * sub[1] * sub[2]].view(sub)
        for layout in ("RGGB", "GBRG"):
            errs.append(check_normalize(view, layout, 4095, what)[1])
    log(f"phase 13 (a) K8 bit for bit against its plain version: 20x3000x4000 in "
        f"{len(CFA_LAYOUTS)} CFA layouts x white levels {INGEST_WHITES}, 2x3001x4003, "
        f"3x7x9 and bases 2, 6 and 8 bytes off alignment ({len(errs)} cases, max|d| "
        f"{max(errs)})")
    args = native_loader.normalization(CFA_LAYOUTS["RGGB"], [DNG_BLACK] * 4, DNG_WHITE,
                                       INGEST_WB)
    tk = timed(lambda: cuda_ingest.normalize_bayer(frames, *args))
    out_p, ms_p = plain_ms(lambda: cuda_ingest.normalize_bayer_plain(frames, *args))
    bnd = bound(nbytes(frames, out_p), 2 * frames.numel())
    host_u16 = frames.cpu().numpy()
    up_u16, s_u16 = time_upload(host_u16, device)
    if not same_bits(up_u16, frames):
        raise AssertionError("phase 13: the uint16 upload is not a plain copy")
    del up_u16
    host_f32 = out_p.cpu().numpy()
    del out_p
    up_f32, s_f32 = time_upload(host_f32, device)
    del up_f32, host_f32, host_u16
    log(f"phase 13 (a) K8 {shape[0]}x{shape[1]}x{shape[2]} RGGB 10-bit: {time_text(tk)}; "
        f"plain {ms_p:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); upload of the uint16 "
        f"stack {1e3 * s_u16:.2f} ms against {1e3 * s_f32:.2f} ms for the float32 it "
        f"replaces [{CARD}]")
    return dict(err=max(errs), ms=tk.ms, host_us=tk.host_us, plain_ms=ms_p,
                bound_ms=bnd[0], bound_by=bnd[1], cases=len(errs),
                upload_u16_ms=1e3 * s_u16, upload_f32_ms=1e3 * s_f32)


def phase_unpack_kernel(device, n_pixels=12_000_000, seed=14):
    """Phase 13 (b): K9 against its plain version on the card at 12 MP of
    random bytes, RAW10 and RAW12, bit for bit, timed. Returns one row per
    format."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = {}
    for bits in sorted(cuda_ingest.RAW_FORMATS):
        per, nb = cuda_ingest.RAW_FORMATS[bits]
        packed = torch.randint(0, 256, (n_pixels // per * nb + 3,), generator=g,
                               device=device, dtype=torch.int32).to(torch.uint8)
        out_k = cuda_ingest.unpack_raw(packed, n_pixels, bits)
        cuda_ingest.unpack_raw_plain(packed, n_pixels, bits)     # warm-up
        out_p, ms_p = plain_ms(lambda: cuda_ingest.unpack_raw_plain(packed, n_pixels,
                                                                    bits))
        if not same_bits(out_k, out_p):
            raise AssertionError(f"phase 13 K9 RAW{bits}: not bit for bit")
        tk = timed(lambda: cuda_ingest.unpack_raw(packed, n_pixels, bits), n=20)
        bnd = bound(n_pixels // per * nb + nbytes(out_k), 0)
        log(f"phase 13 (b) K9 RAW{bits}, {n_pixels} pixels: bit for bit; {time_text(tk)}; "
            f"plain {ms_p:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}) [{CARD}]")
        rows[bits] = dict(err=0.0, ms=tk.ms, host_us=tk.host_us, plain_ms=ms_p,
                          bound_ms=bnd[0], bound_by=bnd[1])
    return rows


class StandInRaw:
    """The surface of ``rawpy.RawPy`` that ``load_dng_burst`` reads: one
    frame of the phase 13 (c) burst, 10 bits over a black level of 64,
    RGGB with rawpy's 3 for the second green."""

    def __init__(self, image):
        self.raw_image = image
        self.white_level = DNG_WHITE
        self.black_level_per_channel = [DNG_BLACK] * 4
        self.camera_whitebalance = list(INGEST_WB)
        self.raw_pattern = np.array([[0, 1], [3, 2]])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class StandInRawpy:
    """``rawpy`` for phase 13 (c): ``imread`` hands out the frame of the
    file's name; nothing is decoded."""

    def __init__(self, images):
        self.images = images

    def imread(self, path):
        return StandInRaw(self.images[os.path.basename(path)])


class StandInTag:
    def __init__(self, values):
        self.values = values

    def __str__(self):
        return str(self.values)


class StandInExifread:
    """``exifread`` for phase 13 (c): ISO 100, orientation 1."""

    @staticmethod
    def process_file(f):
        return {"EXIF ISOSpeedRatings": StandInTag(100),
                "Image Orientation": StandInTag([1])}


@contextlib.contextmanager
def stand_in_decoder(images):
    """``rawpy`` and ``exifread`` stood in by the classes above in
    ``sys.modules`` (the card's machine has neither), removed after."""
    saved = {m: sys.modules.get(m) for m in ("rawpy", "exifread")}
    sys.modules["rawpy"] = StandInRawpy(images)
    sys.modules["exifread"] = StandInExifread()
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def frame_uploads(raw, device, n=2):
    """Seconds of the fastest of ``n`` uploads of the uint16 stack ``raw``
    frame by frame into one device stack, as ``load_dng_burst`` does."""
    stack = torch.empty(raw.shape, dtype=torch.uint16, device=device)
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(raw)):
            stack[i].copy_(torch.from_numpy(raw[i]))
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_dng(device, k8_ms):
    """Phase 13 (c): the phase 4 burst quantised to 10-bit uint16 (black
    level 64, white balance :data:`INGEST_WB`), written as 20 empty ``.dng``
    placeholders under ``build/`` and read through ``process(<folder>)`` on
    the card in the default configuration (the fused form), rawpy and
    exifread stood in: K8 launched once, the pipeline's launches those of
    the fused form, the peak under its limit, the image that of
    ``process_arrays`` on the frames normalized by K8's plain version on
    the CPU and uploaded. The load's split, timed apart: the frames'
    uploads (:func:`frame_uploads`), K8 (``k8_ms``, phase 13 (a) at this
    shape); the decode is stood in and takes no time."""
    frames = make_burst(3000, 4000, 20, 0, device)
    n_frames, h, w = frames.shape
    raw = torch.round(frames * (DNG_WHITE - DNG_BLACK) + DNG_BLACK).clamp_(
        0, DNG_WHITE).to(torch.int16).cpu().numpy().view(np.uint16)
    del frames
    upload_ms = 1e3 * frame_uploads(raw, device)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase13_", dir=os.path.join(ROOT, "build"))
    images = {f"{i:02d}.dng": raw[i] for i in range(n_frames)}
    try:
        for name in images:
            open(os.path.join(tmp, name), "wb").close()
        with stand_in_decoder(images):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burst = load_burst(tmp, device=device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if not (isinstance(burst.comp_raws, torch.Tensor)
                    and burst.comp_raws.device.type == torch.device(device).type):
                raise AssertionError("phase 13: the DNG load left the frames off the card")
            cfa, wb = burst.cfa, burst.white_balance
            del burst
            config = process_config("auto")
            expect = dict(BRIGHT_LAUNCHES[DEFAULT_FORM], K8=1)
            image, dt, got, peak = run_once(
                lambda: process(tmp, config, device=device), lambda: expect,
                "phase 13 process(DNG folder)", (2 * h, 2 * w, 3))
    finally:
        shutil.rmtree(tmp)
    form = pipeline_form(config)
    if form != DEFAULT_FORM or peak > MAX_PEAK_GIB[DEFAULT_FORM] * 2**30:
        raise AssertionError(f"phase 13 process(DNG folder): form {form}, peak memory "
                             f"{peak / 2**30:.3f} GiB (limit {MAX_PEAK_GIB[DEFAULT_FORM]})")
    log(f"phase 13 (c) process(<folder of {n_frames} .dng>), decoder stood in (rawpy and "
        f"exifread replaced in sys.modules; the card's machine has neither): "
        f"{dt:.4f} s, {form} form, Ts={config.block_matching.tuning.tile_size}; peak "
        f"memory {peak / 2**30:.3f} GiB; launches {got}; the load alone {1e3 * load_s:.2f} "
        f"ms; timed apart: the frames' uint16 uploads {upload_ms:.2f} ms, K8 {k8_ms:.4f} "
        f"ms, the decode none (stood in) [{CARD}]")
    args = native_loader.normalization(cfa, [DNG_BLACK] * 4, DNG_WHITE, wb)
    plain = cuda_ingest.normalize_bayer_plain(torch.from_numpy(raw), *args).to(device)
    want, _ = process_arrays(plain[0], plain[1:], process_config("auto"), cfa=cfa,
                             white_balance=wb, device=device)
    del plain
    d = (image - want).abs()[8:-8, 8:-8]
    equal = torch.equal(image, want)
    log(f"phase 13 (c) against process_arrays on the frames normalized by K8's plain "
        f"version on the CPU: equal bit for bit {equal}; interior mean|d| "
        f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e}")
    if not (float(d.mean()) < 1e-4 and float(d.max()) < 1e-3):
        raise AssertionError(f"phase 13 process(DNG folder) against process_arrays: "
                             f"mean|d| {float(d.mean())}, max|d| {float(d.max())}")
    return dict(launches=got, process_s=dt, peak_bytes=peak, load_ms=1e3 * load_s,
                upload_ms=upload_ms, equal=equal)


def ingest_entries(norm, unpack, dng, k9_launches, bench_launches, ptxas):
    """K8's and K9's entries of the ``kernels`` line: K8's main case (20x3000x4000,
    phase 13 (a)) and its launches in ``process(<DNG folder>)`` (phase 13
    (c)); K9 at 12 MP (RAW10, RAW12 beside it) and its launches in the
    user's unpacking entry (phase 10 (f), one call per format)."""
    out = []
    for key, row, launches, extra in (
            ("K8", norm, dng["launches"]["K8"],
             {"launches_in": "process(<DNG folder>), 20x3000x4000 (phase 13 (c))",
              "launches_bench": bench_launches["K8"], "host_us": norm["host_us"],
              "cases": norm["cases"], "upload_u16_ms": norm["upload_u16_ms"],
              "upload_f32_ms": norm["upload_f32_ms"], "dng_load_ms": dng["load_ms"],
              "dng_upload_ms": dng["upload_ms"],
              "dng_image_equal": dng["equal"],
              "registers": ptxas["normalize_kernel"]["registers"]}),
            ("K9", unpack[10], k9_launches,
             {"launches_in": "io.unpack.unpack_raw10 and unpack_raw12 on 12 MP, once "
              "each (phase 10 (f))", "launches_bench": bench_launches["K9"],
              "host_us": unpack[10]["host_us"], "raw12": unpack[12],
              "registers": ptxas["unpack_kernel<10>"]["registers"]})):
        name, _, src, rep = KERNELS[key]
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "replaces_kind": "host C++ (native/burst_loader.cpp), no pl.pallas_call",
                    "launches": launches, "max_abs_err": row["err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": None, **extra})
    return out


def fused_entry(rows, launches, slice_k6, ptxas):
    """K6's entry of the ``kernels`` line: the main path's case (19 frames
    of 3000x4000, x2, Ts=16, Bayer-steerable), its launches per run of the
    fused bright burst, and per variant and case the rows of phase 12 (a)."""
    main = next(e for e in rows if (e["Ts"], e["s"], e["variant"], e["denoise"])
                == FUSED_MAIN_CASES[0][:4] and e["frames"] == F_MAIN)
    name, _, src, rep = KERNELS["K6"]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "replaces_also": "hmsr_tpu/models/merge_fused.py:28",
        "replaces_kind": "XLA (no pl.pallas_call)",
        "launches": launches, "launches_in": "the fused bright burst (phase 12 (c)), "
        "per run", "max_abs_err": max(e["err"] for e in rows), "ms": main["ms"],
        "host_us": main["host_us"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "registers": ptxas[merge_instance(FUSED_KERNEL, False, False)]["registers"],
        "rel_err": max(e["rel_err"] for e in rows),
        "starved_flips": sum(e["starved_flips"] for e in rows),
        "slice_launches": slice_k6,
        "cases": [{k: e[k] for k in ("Ts", "s", "variant", "denoise", "frames", "ms",
                                     "host_us", "plain_ms", "bound_ms", "bound_by",
                                     "registers", "err", "rel_err")} for e in rows]}


def refill_entry(groups, images, real, launches, ptxas):
    """K7's entry of the ``kernels`` line: the main path's case (3x6016x8000
    accumulators, Ts=16 x2, per slab) on the stress input, as in earlier
    versions of this line (``ms_input``), beside it the same on K6's real
    accumulators of phase 12 (a)'s main case (``real_ms``) and the scan
    forms' image layout on that case's K5' and reference accumulators; its
    launches per run of the fused and of the scan bright burst; every case
    of both layouts."""
    main = groups[0]
    name, _, src, rep = KERNELS["K7"]
    rows = real + groups + images
    return {
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "replaces_also": ["hmsr_tpu/models/merge_fused.py:356",
                          "hmsr_tpu/models/pipeline.py:289",
                          "hmsr_tpu/models/pipeline.py:325",
                          "hmsr_tpu/models/pipeline.py:365",
                          "hmsr_tpu/parallel/sharded.py:226"],
        "replaces_kind": "XLA (no pl.pallas_call)",
        "layouts": ["slab", "tile", "image"],
        "launches": launches["fused"], "launches_in": "the fused bright burst (phase 12 "
        "(c)), per run", "launches_scan": launches["scan"],
        "max_abs_err": max(e["err"] for e in rows), "ms": main["ms"],
        "host_us": main["host_us"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "ms_input": f"stress ({main['what']}: starved_accumulators, every piece on "
        "the slow path), the input of ms in earlier versions of this line",
        "real_ms": real[0]["ms"], "real_plain_ms": real[0]["plain_ms"],
        "real_input": real[0]["what"],
        "image_ms": real[1]["ms"], "image_bound_ms": real[1]["bound_ms"],
        "registers": ptxas[REFILL_KERNEL]["registers"],
        "cases": [{k: e[k] for k in ("layout", "what", "input", "shape", "ms", "host_us",
                                     "plain_ms", "bound_ms", "bound_by", "err",
                                     "slow_pieces", "pieces")} for e in rows]}


def merge_variant_entries(key, rows, ptxas, entry, variant_launches):
    """The K5 or K5' entry's ``variants``: per variant of
    :data:`MERGE_VARIANTS`, its numbers per launch at the main path's shapes
    (phase 2: 3000x4000, x2, Ts=16; K5' 5 frames), its instantiation's
    registers, and its launches in the run that drives it: the main path
    (bayer-steerable: phases 4 and 5), the grey cell (grey-steerable: phase
    8), the 512^2 slice (the iso variants: phase 3)."""
    out = {}
    for variant, (grey, iso) in MERGE_VARIANTS.items():
        row = next(e for e in rows if e["variant"] == variant and e["Ts"] == MAIN_TS
                   and e["s"] == 2)
        out[variant] = {
            "ms": row["ms"], "host_us": row["host_us"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "max_abs_err": max(e["err"] for e in rows if e["variant"] == variant),
            "registers": ptxas[merge_instance(MERGE_KERNELS[key], grey,
                                              iso)]["registers"],
            "launches": entry["launches"] if variant == "bayer-steerable"
            else variant_launches[variant][key],
            "launches_in": {"bayer-steerable": "main path",
                            "grey-steerable": "grey cell (phase 8)"}.get(
                                variant, "512^2 slice (phase 3)")}
    return out


def main():
    global CARD
    check_no_reference_imports()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    device = "cuda"
    CARD = card()
    log(CARD)
    log(f"phase 0 torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()

    ptxas = phase_build((3000, 4000))

    log("phase 2 kernels against their plain versions (main-path shapes)")
    stats = phase_kernels(device, (3000, 4000))
    variant_launches = phase_slice(device)
    frames = make_burst(3000, 4000, 20, 0, device)
    full_image = phase_full(frames, device)["image"]
    launches = counts()
    proc = phase_process(frames, device)
    launches["K5'"] = proc["chunked"]["launches"]["K5'"]
    del proc
    phase_dark(device)
    log("phase 7 the probes P1 and P2 against their plain versions")
    p1, p1_ns = probe_cta_cost.run_p1(device, (16384, 65536), log=log, tag=CARD)
    p2 = probe_cta_cost.run_p2(device, log=log, tag=CARD)
    log("phase 8 the bench.py cells grey, x3 and x1 on the phase 4 burst")
    cells = phase_cells(frames, device)
    del frames
    variant_launches["grey-steerable"] = {
        "K5": cells["grey"]["launches"]["K5"],
        "K5'": cells["grey"]["chunked_launches"]["K5'"]}
    log("phase 9 the pipeline's switches: the 512^2 slice, the full burst, accuracy")
    phase_switch_slice(device)
    frames = make_burst(3000, 4000, 20, 0, device)
    phase_switch_cells(frames, device)
    del frames
    phase_accuracy(device)
    log("phase 10 the user's entry: the CLI, the finishing routes, the graft entry, "
        "unprocess, unpacking")
    frames = make_burst(3000, 4000, 20, 0, device)
    user_entry = phase_entry(frames, device)
    del frames
    log("phase 11 the multi-device path on torch.distributed (every rank on this card)")
    banded = phase_sharded(device, full_image)
    log("phase 12 the fused and vmapped forms: K6, K7, the 512^2 slice, the full "
        "burst, accuracy")
    fused_rows = phase_fused_kernel(device, ptxas)
    refill_groups_rows, refill_image_rows = phase_refill_kernel(device, ptxas)
    slice_k6 = phase_fused_slice(device)
    frames = make_burst(3000, 4000, 20, 0, device)
    fused = phase_fused_full(frames, device, full_image)
    del frames, full_image
    phase_fused_accuracy(device)
    log("phase 13 raw ingestion: K8 and K9 against their plain versions, the DNG entry")
    norm = phase_normalize(device)
    unpack = phase_unpack_kernel(device)
    dng = phase_dng(device, norm["ms"])
    check_no_reference_imports()
    log(f"phases 0-13 took {time.perf_counter() - t_start:.1f} s [{CARD}]")

    entries = []
    for key, (name, fn, src, rep) in KERNELS.items():
        if key == "K6":
            entries.append(fused_entry(fused_rows, fused["launches"]["K6"], slice_k6,
                                       ptxas))
            continue
        if key == "K7":
            entries.append(refill_entry(
                refill_groups_rows, refill_image_rows, fused_rows[0]["refill_rows"],
                {"fused": fused["launches"]["K7"], "scan": launches["K7"]}, ptxas))
            continue
        if key == "K8":
            entries += ingest_entries(norm, unpack, dng,
                                      user_entry["unpack"]["launches"], launches, ptxas)
            continue
        if key == "K9":
            continue
        # per frame of the main path: the Ts=16 launches, each as often as a
        # frame of the path launches it
        main_path = [e for e in stats[key] if e["Ts"] == MAIN_TS and e["per_frame"]]

        def per_frame(field):
            return sum(e["per_frame"] * e[field] for e in main_path)

        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[key],
            "max_abs_err": max(e["err"] for e in stats[key]),
            "ms": per_frame("ms"), "host_us": per_frame("host_us"),
            "plain_ms": per_frame("plain_ms"),
            "bound_ms": per_frame("bound_ms"),
            "bound_by": max(main_path, key=lambda e: e["per_frame"] * e["bound_ms"])
            ["bound_by"],
            "library_ms": None}
        if key == "K5'":
            entry["k5_sequential_ms"] = per_frame("seq_ms")
        if key == "K2":
            entry["per_step_bound_ms"] = per_frame("step_bound_ms")
        if key in ICA_KERNELS:
            entry["registers"] = ptxas[ICA_KERNELS[key]]["registers"]
        if key == "K10":
            entry.update({k: ptxas[f"{ROBUSTNESS_KERNEL}<3,16>"][k]
                          for k in ("registers", "spill_stores", "spill_loads")})
        if key in MERGE_KERNELS:
            entry["registers"] = ptxas[merge_instance(MERGE_KERNELS[key], False,
                                                      False)]["registers"]
            entry["variants"] = merge_variant_entries(key, stats[key], ptxas, entry,
                                                      variant_launches)
        if key == "K5":
            entry["banded"] = banded
        entries.append(entry)
    # the probes: not on the path (0 launches there); P1 at its largest grid
    for key, row in (("P1", p1["empty"][-1]), ("P2", p2[-1])):
        name, _, src, rep = PROBES[key]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": row["err"], "ms": row["ms"],
            "host_us": row["host_us"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    entries[-2]["ns_per_block"] = p1_ns
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
