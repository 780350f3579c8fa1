"""Tile-wise translational block matching (twin of
:mod:`hmsr_tpu.models.block_matching`). The JAX package's L2 correlation
backends (``tpu.correlation``: ``direct``, ``fft``) give the same
displacements; the port has one search, K1, for both.

Flow conventions: search windows sit at ``round(flow)`` (half-to-even); L2
clamps coordinates to the image and ADDS the integer displacement to the
unrounded flow; L1 fills out-of-bounds pixels with 0 and REPLACES the flow
with ``round(flow) + displacement``. The search itself is K1
(:func:`hmsr_tpu_torch.ops.cuda_ica.block_match`).
"""

import torch

from ..ops.cuda_ica import block_match, flow_windows, tile_origins


def extract_flow_patches(moving, flow, tile_size, radius, fill=None):
    """Per-tile search windows of size (ts + 2r)^2 at round(flow);
    ``fill=None`` clamps coordinates, a float fills out of bounds."""
    top, left = tile_origins(torch.round(flow).long(), tile_size, radius)
    return flow_windows(moving, top, left, tile_size + 2 * radius, fill=fill)


def match_l2(ref_tiles, moving, flow, tile_size, radius):
    """One level of L2 block matching; returns the updated float flow.

    ``ref_tiles``: (ny, nx, ts, ts) reference tiles (precomputed at init).
    """
    flow = flow.contiguous()
    d = block_match(ref_tiles, moving, flow, tile_size, radius, "L2")
    return flow + d.to(flow.dtype)


def match_l1(ref_lvl, moving, flow, tile_size, radius):
    """One level of exhaustive L1 search; returns the updated float flow.

    Tiles are carved from the top-left ny*ts x nx*ts region of ``ref_lvl``.
    """
    ny, nx = flow.shape[:2]
    ts = int(tile_size)
    ref_tiles = ref_lvl[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)
    s_flow = torch.round(flow).contiguous()
    d = block_match(ref_tiles, moving, s_flow, ts, radius, "L1")
    return s_flow + d.to(flow.dtype)
