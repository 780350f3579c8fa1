"""Single-device entry of the port (twin of ``entry`` in the JAX package's
``__graft_entry__.py``): the x2 Bayer burst pipeline at 128x128 with 4
frames, on the card unless the caller asks for the CPU.

    fn, args = entry()
    image, debug = fn(*args)        # image (256, 256, 3) on the card

The JAX file's multi-device dry run needs the sharded pipeline, which the
port does not have yet.
"""

import torch

from .configs import default_config, sanitize_config, update_snr_config
from .io.synthetic import DEFAULT_CFA, make_synthetic_burst
from .models.pipeline import make_pipeline
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
