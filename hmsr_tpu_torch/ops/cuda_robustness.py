"""K10 (the robustness map of one compared frame, one launch): CUDA kernel
wrapper and its plain PyTorch version.

The chain of :func:`hmsr_tpu.models.robustness.compute_robustness` (Alg. 6):
guide image -> 3x3 local means -> Dodgson upscale-warp to the raw grid (K4's
arithmetic) -> channel distance -> noise-model correction -> flow-discontinuity
term S -> threshold -> 5x5 local minimum. Out-of-grid warped statistics are
carried as an explicit validity mask (R = 0 there), as in the JAX package. The
kernel is ``csrc/robustness.cu``; its header says what bounds it on the H100
and how the design answers it. The wrapper launches it for CUDA tensors and
runs the plain version only for CPU tensors; ``robustness_fused.launches``
counts kernel launches.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .cuda_warp import upscale_warp
from .stencils import edge_pad, local_min_5x5, local_stats_3x3
from ..utils.types import DEFAULT_FLOAT

#: K10's threads per block, its cap on a run-time-Ts layout's shared memory
#: and the bytes of its per-tile record (``csrc/robustness.cu``)
ROB_THREADS = 256
ROB_SMEM_MAX = 100 * 1024
ROB_TILE_BYTES = 17 * 4
#: tile sizes with an instantiation of their own (the main paths')
ROB_FIXED = (16, 32, 64)


def compute_guide_image(raw, cfa_pattern, white_balance):
    """Bayer quad -> half-res RGB (3, H/2, W/2) with white balance undone
    (Alg. 7), from strided quad phases."""
    h, w = raw.shape
    cfa = np.asarray(cfa_pattern, dtype=np.int64)
    quads = raw[: (h // 2) * 2, : (w // 2) * 2].reshape(h // 2, 2, w // 2, 2)
    chans = [None, None, None]
    green = 0.0
    for i in range(2):
        for j in range(2):
            c = int(cfa[i, j])
            x = quads[:, i, :, j] / white_balance[c]
            if c == 1:
                green = green + x
            else:
                chans[c] = x
    chans[1] = green / 2.0
    return torch.stack(chans, dim=0).to(DEFAULT_FLOAT)


def compute_s(flow, m_th, s1, s2):
    """Flow-discontinuity map: s1 where the 3x3 flow range exceeds Mt, else s2."""
    def rng3(a):
        h, w = a.shape
        p = edge_pad(edge_pad(a, 1, 0), 1, 1)
        hi = lo = p[0:h, 0:w]
        for i in range(3):
            for j in range(3):
                v = p[i:i + h, j:j + w]
                hi = torch.maximum(hi, v)
                lo = torch.minimum(lo, v)
        return hi - lo

    d0 = rng3(flow[..., 0])
    d1 = rng3(flow[..., 1])
    return torch.where(d0 * d0 + d1 * d1 > m_th * m_th,
                       torch.full_like(d0, float(s1)),
                       torch.full_like(d0, float(s2)))


def robustness_plain(comp_img, ref_stats, flow, cfa_pattern, white_balance, grey,
                     tile_size, m_th, s1, s2, t):
    """Plain version of K10: the robustness map R (H, W) of ``comp_img``
    against the reference's statistics ``ref_stats`` (``RefStats``:
    means and d_t (c, H, W), sigma_sq and valid (H, W)), from the per-tile
    ``flow`` (ny, nx, 2). The warp is K4 on CUDA tensors (bit for bit its
    plain version); the channel distance is summed in channel order."""
    if grey:
        guide, upscale = comp_img[None], 1
    else:
        guide, upscale = compute_guide_image(comp_img, cfa_pattern, white_balance), 2
    comp_means, _ = local_stats_3x3(guide)
    out_shape = (guide.shape[1] * upscale, guide.shape[2] * upscale)
    comp_means, comp_valid = upscale_warp(comp_means.contiguous(), upscale, tile_size,
                                          flow, out_shape)

    d_p = torch.abs(ref_stats.means - comp_means)
    d_t = ref_stats.d_t
    d_p_sq = d_p * d_p
    shrink = d_p_sq / (d_p_sq + d_t * d_t)
    terms = d_p_sq * shrink * shrink
    d_sq = terms[0]
    for k in range(1, terms.shape[0]):
        d_sq = d_sq + terms[k]

    S = compute_s(flow, m_th, s1, s2)
    h, w = d_sq.shape
    s_map = S.repeat_interleave(tile_size, 0).repeat_interleave(tile_size, 1)[:h, :w]

    R = torch.clamp(s_map * torch.exp(-d_sq / ref_stats.sigma_sq) - t, 0.0, 1.0)
    R = torch.where(ref_stats.valid & comp_valid, R, torch.zeros((), device=R.device))
    return local_min_5x5(R)


def cfa_code(cfa_pattern):
    """The four 2x2 phases' channels packed 2 bits each (phase ``2 i + j`` at
    bit ``2 (2 i + j)``), as K10 takes them; a pattern other than one red, two
    greens and one blue is refused."""
    chans = [int(c) for c in np.asarray(cfa_pattern).reshape(-1)]
    _build.check_arg(sorted(chans) == [0, 1, 1, 2],
                     f"CFA pattern {chans}: expected one red, two greens, one blue")
    return sum(c << (2 * p) for p, c in enumerate(chans))


def robustness_fused(comp_img, ref_stats, flow, cfa_pattern, white_balance, grey,
                     tile_size, m_th, s1, s2, t):
    """K10: the robustness map R (H, W) of one compared frame in one launch
    (the arguments of :func:`robustness_plain`). ``comp_img`` (h, w) float32;
    (H, W) is the raw grid of whole Bayer quads, or (h, w) in grey mode;
    every tensor contiguous, ``flow`` covering (H, W) with ``tile_size``
    tiles."""
    Ts = int(tile_size)
    u, c = (1, 1) if grey else (2, 3)
    dev = comp_img.device
    _build.check_f32("comp_img", comp_img, 2, dev)
    H, W = comp_img.shape[0] // u * u, comp_img.shape[1] // u * u
    for name, x, shape in (("means", ref_stats.means, (c, H, W)),
                           ("d_t", ref_stats.d_t, (c, H, W)),
                           ("sigma_sq", ref_stats.sigma_sq, (H, W))):
        _build.check_f32(name, x, len(shape), dev)
        _build.check_arg(tuple(x.shape) == shape,
                         f"{name}: {tuple(x.shape)}, expected {shape}")
    valid = ref_stats.valid
    _build.check_arg(valid.dtype == torch.bool and tuple(valid.shape) == (H, W)
                     and valid.device == dev,
                     f"valid: {valid.dtype} {tuple(valid.shape)} on {valid.device}, "
                     f"expected bool {(H, W)} on {dev}")
    _build.check_f32("flow", flow, 3, dev)
    _build.check_arg(Ts >= 2 and Ts % u == 0,
                     f"tile size {Ts}: at least 2 and a multiple of {u}")
    _build.check_arg(flow.shape[0] >= -(-H // Ts) and flow.shape[1] >= -(-W // Ts)
                     and flow.shape[2] == 2,
                     f"flow {tuple(flow.shape)} does not cover {(H, W)} at Ts={Ts}")
    _build.check_arg(all(x.is_contiguous() for x in (comp_img, ref_stats.means,
                                                     ref_stats.d_t, ref_stats.sigma_sq,
                                                     valid, flow)),
                     "comp_img, the reference's statistics and flow must be contiguous")
    code = 0 if grey else cfa_code(cfa_pattern)
    if dev.type == "cpu":
        return robustness_plain(comp_img, ref_stats, flow, cfa_pattern, white_balance,
                                grey, Ts, m_th, s1, s2, t)
    _build.require_cuda(dev)
    # the plain version divides by Python numbers: on the card a multiply by
    # the float32 reciprocal
    iwb = [1.0 if grey else float(np.float32(1.0) / np.float32(white_balance[k]))
           for k in range(3)]
    out = torch.empty((H, W), dtype=DEFAULT_FLOAT, device=dev)
    lib = _build.library()
    err = lib.hmsr_robustness(
        _build.ptr(comp_img), comp_img.shape[0], comp_img.shape[1],
        _build.ptr(ref_stats.means), _build.ptr(ref_stats.d_t),
        _build.ptr(ref_stats.sigma_sq), _build.ptr(valid), _build.ptr(flow),
        flow.shape[0], flow.shape[1], c, Ts, code, *iwb,
        float(np.float32(m_th * m_th)), float(s1), float(s2), float(t), _build.ptr(out),
        _build.stream_of(comp_img))
    _build.check(err, "hmsr_robustness")
    robustness_fused.launches += 1
    return out


robustness_fused.launches = 0


def _layout_of(Ts, u, c, ty, tx):
    def nwin(n):
        return (n + u - 2) // u + 3

    ey, ex = ty * Ts + 4, tx * Ts + 4
    hw, iw = nwin(2), nwin(Ts)
    mr, mc = 2 * hw + ty * iw, 2 * hw + tx * iw
    gr, gc = mr + 2 * (ty + 2), mc + 2 * (tx + 2)
    smem = (16 * ((tx + 2) * ey + (ty + 2) * ex) + 4 * c * mr * mc
            + max(4 * c * gr * gc, 4 * (ey + ty * Ts) * ex)
            + (ty + 2) * (tx + 2) * ROB_TILE_BYTES)
    return dict(tiles_y=ty, tiles_x=tx, threads=ROB_THREADS, smem_bytes=smem,
                fixed=Ts in ROB_FIXED)


def robustness_layout(tile_size, grey=False):
    """K10's launch layout for ``tile_size`` in Bayer or grey mode, as
    ``csrc/robustness.cu:rob_layout`` computes it: a block of ``threads``
    owns ``tiles_y`` x ``tiles_x`` tiles (about 32 x 64 pixels) and takes
    ``smem_bytes`` of dynamic shared memory; ``fixed``: an instantiation of
    its own, else the one with Ts at run time. A small Ts whose layout would
    take more than :data:`ROB_SMEM_MAX` halves the region, the longer side
    first."""
    Ts = int(tile_size)
    u, c = (1, 1) if grey else (2, 3)
    _build.check_arg(Ts >= 2 and Ts % u == 0,
                     f"tile size {Ts}: at least 2 and a multiple of {u}")
    ty, tx = (1 if Ts >= 32 else 32 // Ts), (1 if Ts >= 64 else 64 // Ts)
    lay = _layout_of(Ts, u, c, ty, tx)
    while lay["smem_bytes"] > ROB_SMEM_MAX and (ty > 1 or tx > 1):
        if tx >= 2 * ty or ty == 1:
            tx = (tx + 1) // 2
        else:
            ty = (ty + 1) // 2
        lay = _layout_of(Ts, u, c, ty, tx)
    return lay


def library_layout(tile_size, grey=False):
    """:func:`robustness_layout` as the built library computes it. Needs the
    CUDA toolchain (it builds the library), not a card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().hmsr_robustness_layout(int(tile_size), 1 if grey else 3,
                                                         out),
                 "hmsr_robustness_layout")
    return dict(tiles_y=out[0], tiles_x=out[1], threads=out[2], smem_bytes=out[3],
                fixed=bool(out[4]))
