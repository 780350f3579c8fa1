"""K4 (robustness upscale-warp): CUDA kernel wrapper and its plain PyTorch
version.

Counterpart of :mod:`hmsr_tpu.ops.pallas_warp`. The kernel is
``csrc/warp.cu`` (replaces ``pallas_warp.py:_warp_kernel``); its header says
what bounds it on the H100 and how the design answers it. The wrapper
launches the kernel for CUDA tensors and runs the plain version only for CPU
tensors; ``upscale_warp.launches`` counts kernel launches.
"""

import ctypes

import torch

from . import _build
from .cuda_merge import scale_divisor
from .dogson import dogson_quadratic_kernel
from ..utils.types import DEFAULT_FLOAT


def upscale_warp_plain(stats, upscale, tile_size, flow, out_shape):
    """Plain version of K4, the semantics of
    :func:`hmsr_tpu.models.robustness.upscale_warp_stats_tiled` written per
    raw pixel.

    ``stats``: (c, lh, lw) on the guide grid; ``flow``: (ny, nx, 2) per raw
    Ts-tile; ``out_shape``: (H, W). Returns ``(hr_stats (c, H, W),
    valid (H, W) bool)``. Within a tile the 3x3 Dodgson centre follows the
    staircase ``(Sy + 1) + (y_loc + ph_y) // u``; tap values come from the
    window at the clipped origin (edge-clamped), weights from the clamped
    true centre, and a tile whose origin was clipped is invalid as a whole.
    """
    c, lh, lw = stats.shape
    H, W = out_shape
    Ts, u = int(tile_size), int(upscale)
    WIN = Ts // u + 4
    PAD = WIN + 1
    dev = stats.device
    Y = torch.arange(H, device=dev)[:, None]
    X = torch.arange(W, device=dev)[None, :]
    ty, tx = Y // Ts, X // Ts
    fx = flow[ty, tx, 0].to(DEFAULT_FLOAT)
    fy = flow[ty, tx, 1].to(DEFAULT_FLOAT)

    def axis(f, t, loc, n):
        base = t * Ts + torch.floor(f + 0.5).long()
        S = torch.div(base, u, rounding_mode="floor") - 1
        ph = base - u * (S + 1)
        Sc = torch.clamp(S, -PAD, n + PAD - WIN)
        q = torch.div(loc + ph, u, rounding_mode="floor")
        return S, Sc, q

    Sy, Syc, q_y = axis(fy, ty, Y - ty * Ts, lh)
    Sx, Sxc, q_x = axis(fx, tx, X - tx * Ts, lw)
    u_dev = scale_divisor(u, dev)       # a true division on the card too
    lr_y = (Y.to(DEFAULT_FLOAT) + fy + 0.5) / u_dev - 0.5
    lr_x = (X.to(DEFAULT_FLOAT) + fx + 0.5) / u_dev - 0.5
    valid = (lr_y >= 0) & (lr_y < lh) & (lr_x >= 0) & (lr_x < lw) & \
        (Syc == Sy) & (Sxc == Sx)

    acc = torch.zeros((c, H, W), dtype=DEFAULT_FLOAT, device=dev)
    w_acc = torch.zeros((H, W), dtype=DEFAULT_FLOAT, device=dev)
    for i in (-1, 0, 1):
        yc = torch.clamp(Sy + 1 + q_y + i, 0, lh - 1).to(DEFAULT_FLOAT)
        wy = dogson_quadratic_kernel(yc - lr_y)
        vy = torch.clamp(Syc + 1 + q_y + i, 0, lh - 1)
        for j in (-1, 0, 1):
            xc = torch.clamp(Sx + 1 + q_x + j, 0, lw - 1).to(DEFAULT_FLOAT)
            wgt = wy * dogson_quadratic_kernel(xc - lr_x)
            vx = torch.clamp(Sxc + 1 + q_x + j, 0, lw - 1)
            acc = acc + stats[:, vy, vx] * wgt[None]
            w_acc = w_acc + wgt
    return acc / w_acc[None], valid


def upscale_warp(stats, upscale, tile_size, flow, out_shape):
    """K4: Dodgson upscale-warp of guide-grid stats to the raw grid.

    ``stats``: (c <= 4, lh, lw) contiguous; ``flow``: (ny, nx, 2)
    contiguous, covering ``out_shape`` with Ts-tiles. Returns
    ``(hr_stats (c, H, W), valid (H, W) bool)``.
    """
    Ts, u = int(tile_size), int(upscale)
    H, W = (int(v) for v in out_shape)
    dev = stats.device
    _build.check_f32("stats", stats, 3, dev)
    _build.check_f32("flow", flow, 3, dev)
    _build.check_arg(stats.shape[0] <= 4, f"at most 4 channels, got {stats.shape[0]}")
    _build.check_arg(flow.shape[0] >= -(-H // Ts) and flow.shape[1] >= -(-W // Ts)
                     and flow.shape[2] == 2,
                     f"flow {tuple(flow.shape)} does not cover {(H, W)} at Ts={Ts}")
    _build.check_arg(Ts % u == 0, f"tile size {Ts} not a multiple of {u}")
    if dev.type == "cpu":
        return upscale_warp_plain(stats, u, Ts, flow, (H, W))
    _build.require_cuda(dev)
    _build.check_arg(stats.is_contiguous() and flow.is_contiguous(),
                     "stats and flow must be contiguous")
    c, lh, lw = stats.shape
    out = torch.empty((c, H, W), dtype=DEFAULT_FLOAT, device=dev)
    valid = torch.empty((H, W), dtype=torch.bool, device=dev)
    lib = _build.library()
    code = lib.hmsr_upscale_warp(
        _build.ptr(stats), c, lh, lw, _build.ptr(flow), flow.shape[1], Ts, u, H, W, _build.ptr(out), _build.ptr(valid),
        _build.stream_of(stats))
    _build.check(code, "hmsr_upscale_warp")
    upscale_warp.launches += 1
    return out, valid


upscale_warp.launches = 0


def warp_layout(tile_size, upscale, channels):
    """The launch layout of K4 for (Ts, u, c), as the built library computes
    it: ``tiles`` of one tile row per block, ``threads`` per block, the
    staged window's side ``window``, ``smem_bytes`` of dynamic shared
    memory per block and ``fixed`` (an instantiation of its own, else the
    one with run-time Ts and u). Needs the CUDA toolchain (it builds the library), not
    a card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().hmsr_warp_layout(int(tile_size), int(upscale),
                                                    int(channels), out),
                 "hmsr_warp_layout")
    return dict(tiles=out[0], threads=out[1], window=out[2], smem_bytes=out[3],
                fixed=bool(out[4]))
