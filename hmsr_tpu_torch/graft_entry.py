"""Entry points of the port (twins of the JAX package's
``__graft_entry__.py``), on the card unless the caller asks for the CPU.

- :func:`entry`: the x2 Bayer burst pipeline at 128x128 with 4 frames::

      fn, args = entry()
      image, debug = fn(*args)        # image (256, 256, 3) on the card

- :func:`dryrun_multichip`: the sharded pipeline
  (:mod:`hmsr_tpu_torch.parallel`) in ``n`` ranks that it spawns itself,
  each of its meshes held against the single-device pipeline::

      python -c "from hmsr_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(4)"
"""

import os

import numpy as np
import torch

from .configs import default_config, sanitize_config, update_snr_config
from .io.synthetic import DEFAULT_CFA, make_synthetic_burst
from .models.pipeline import make_pipeline
from .parallel import make_mesh, make_sharded_pipeline, pad_frames, spawn_ranks
from .synthetic import ALPHA, BETA, affine_curves
from .utils.types import DEFAULT_FLOAT, resolve_device


def small_config(scale=2, h=128, w=128):
    """The two-level configuration of the entry: Ts 16 on both levels (L1
    r=1 on the finest, L2 r=4 on the coarse one), the merge constants of
    SNR 20, the affine noise model, the accumulated-robustness denoiser off."""
    c = default_config()
    c.scale = scale
    c.verbose = 0
    c.block_matching.tuning.tile_size = 16
    c.block_matching.tuning.factors = [1, 2]
    c.block_matching.tuning.tile_size_factors = [1, 1]
    c.block_matching.tuning.search_radii = [1, 4]
    c.block_matching.tuning.metrics = ["L1", "L2"]
    update_snr_config(c, 20)
    c.block_matching.tuning.tile_size = 16
    c.block_matching.tuning.tile_sizes = [16, 16]
    c.noise_model.alpha = ALPHA
    c.noise_model.beta = BETA
    c.accumulated_robustness_denoiser.enabled = False
    sanitize_config(c, (h, w))
    return c


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(ref, comps, std_curve, diff_curve) ->
    (image, debug)``, the x2 Bayer pipeline on ``device``, and a seeded
    128x128 4-frame burst with its affine noise curves there."""
    device = resolve_device(device)
    ref, comps, _, _ = make_synthetic_burst(128, 128, n_frames=4, alpha=ALPHA,
                                            beta=BETA, seed=0)
    fn = make_pipeline(small_config(), DEFAULT_CFA, [1.0, 1.0, 1.0], device)
    example_args = tuple(torch.as_tensor(x, dtype=DEFAULT_FLOAT, device=device)
                         for x in (ref, comps, *affine_curves()))
    return fn, example_args


def dryrun_multichip(n_devices, device="cuda", backend="gloo"):
    """One run of the sharded pipeline in ``n_devices`` ranks on each mesh
    of ``n_devices``: ``(n/2 frames x 2 space)`` when ``n`` is even and
    ``(n x 1)``, at 128x192 with ``n + 2`` frames (padded to the frames
    axis), each held against the single-device scan pipeline at ``atol=5e-4,
    rtol=1e-3`` (the JAX dry run's bound); prints one line per mesh.

    The ranks are new processes (:func:`~hmsr_tpu_torch.parallel.spawn_ranks`,
    ``backend`` gloo or nccl), rank ``r`` on ``cuda:{r % device_count}`` or
    on the CPU. The single-device run also builds the kernels here, once,
    before the ranks start."""
    device = resolve_device(device)
    h, w = 128, 192
    ref, comps, _, _ = make_synthetic_burst(h, w, n_frames=n_devices + 2, alpha=ALPHA,
                                            beta=BETA, seed=1)
    ref, comps = torch.as_tensor(ref), torch.as_tensor(comps)
    single = small_config(h=h, w=w)
    single["tpu"] = {"pipeline": "scan"}    # the sharded pipeline's refill
    want, _ = make_pipeline(single, DEFAULT_CFA, [1.0, 1.0, 1.0], device)(
        ref, comps, *affine_curves())
    shapes = [(n_devices, 1)]
    if n_devices % 2 == 0 and n_devices > 1:
        shapes.insert(0, (n_devices // 2, 2))
    lines = spawn_ranks(_dryrun_rank, n_devices,
                        args=(shapes, ref, comps, want.cpu(), device.type),
                        backend=backend, threads=max(1, os.cpu_count() // n_devices))[0]
    for line in lines:
        print(line, flush=True)
    return lines


def _dryrun_rank(rank, shapes, ref, comps, want, device_type):
    """A rank of :func:`dryrun_multichip`: every mesh, asserted on every
    rank; returns the lines to print."""
    h, w = ref.shape
    config = small_config(h=h, w=w)
    want = np.nan_to_num(want.numpy())
    lines = []
    for n_frames, n_space in shapes:
        mesh = make_mesh(n_frames, n_space)
        device = mesh.device if device_type == "cuda" else torch.device("cpu")
        pipe = make_sharded_pipeline(config, DEFAULT_CFA, [1.0, 1.0, 1.0], mesh, device)
        frames, weights = pad_frames(comps, n_frames)
        out, _ = pipe(ref, frames, weights, *affine_curves())
        assert tuple(out.shape) == (2 * h, 2 * w, 3), out.shape
        assert bool(torch.isfinite(out[8:-8, 8:-8]).all())
        got = np.nan_to_num(out.cpu().numpy())
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
        lines.append(f"dryrun_multichip OK: mesh=({n_frames} frames x {n_space} space), "
                     f"out={tuple(out.shape)}, max|d| vs single-chip = "
                     f"{float(np.max(np.abs(got - want))):.2e}")
    return lines
