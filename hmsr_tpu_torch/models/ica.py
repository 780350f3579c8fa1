"""ICA / inverse-compositional Lucas-Kanade sub-pixel flow refinement (twin
of :mod:`hmsr_tpu.models.ica`).

Per tile: ``n_iter`` Gauss-Newton steps, each with the 2x2 solve against the
tile's Hessian and the rule that tiles with ``|det| < 1e-10`` keep their
flow. The solve's terms depend on the reference alone, so :func:`init_ica`
computes them once per burst (the JAX package keeps its prep in
``ref_state.ica_pallas``). Two forms with the same semantics (the alignment
picks one per level, as the JAX package does):

- :func:`refine_ica_tiled`: all steps of a large level in one K2 launch
  (:func:`hmsr_tpu_torch.ops.cuda_ica.ica_steps`);
- :func:`refine_ica_fused`: all steps in one K3 launch
  (:func:`hmsr_tpu_torch.ops.cuda_ica.ica_fused`), optionally after the L1
  radius-1 block matching (``pallas_ica_fused.match_l1_refine_ica_fused``).
"""

from typing import NamedTuple

import torch

from ..ops.cuda_ica import ica_fused, ica_steps, solve_terms
from ..ops.gradients import sobel_gradients
from ..utils.types import DEFAULT_FLOAT


class IcaRefState(NamedTuple):
    gradx: torch.Tensor     # (lvl_h, lvl_w)
    grady: torch.Tensor
    hessian: torch.Tensor   # (ny, nx, 2, 2)
    terms: torch.Tensor     # (ny, nx, 5): solve_terms(hessian)


def init_ica(ref_lvl, tile_size):
    """Gradients, per-tile Hessians and their solve terms for one pyramid
    level of the ref image."""
    h, w = ref_lvl.shape
    ts = int(tile_size)
    ny, nx = h // ts, w // ts
    gradx, grady = sobel_gradients(ref_lvl)

    def tiles(a):
        return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)

    gx, gy = tiles(gradx), tiles(grady)
    h00 = torch.sum(gx * gx, dim=(-2, -1))
    h01 = torch.sum(gx * gy, dim=(-2, -1))
    h11 = torch.sum(gy * gy, dim=(-2, -1))
    hessian = torch.stack([torch.stack([h00, h01], -1),
                           torch.stack([h01, h11], -1)], -2)
    return IcaRefState(gradx=gradx.contiguous(), grady=grady.contiguous(),
                       hessian=hessian, terms=solve_terms(hessian))


def refine_ica_tiled(ref_lvl, ica_state, moving, flow, tile_size, n_iter):
    """Run ``n_iter`` Gauss-Newton steps; returns the updated (ny, nx, 2) flow."""
    return ica_steps(ref_lvl, ica_state.gradx, ica_state.grady, ica_state.terms,
                     moving, flow.to(DEFAULT_FLOAT).contiguous(), tile_size, n_iter)


def refine_ica_fused(ref_lvl, ica_state, moving, flow, tile_size, n_iter,
                     bm=False):
    """``n_iter`` Gauss-Newton steps in one K3 launch; with ``bm`` they
    follow an L1 radius-1 block matching of ``flow`` (zero fill, flow
    replaced by ``round(flow) + d``). Returns the (ny, nx, 2) flow."""
    return ica_fused(ref_lvl, ica_state.gradx, ica_state.grady, ica_state.terms,
                     moving, flow.to(DEFAULT_FLOAT).contiguous(), tile_size, n_iter, bm)
