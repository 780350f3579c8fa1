"""K1 (block matching), K2 (all ICA Gauss-Newton steps of a large level in
one launch) and K3 (all ICA steps of a small level in one launch, optionally
after an L1 search): CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of :mod:`hmsr_tpu.ops.pallas_ica` and
:mod:`hmsr_tpu.ops.pallas_ica_fused`. The kernels are ``csrc/bm.cu``
(replaces ``pallas_ica.py:_bm_kernel``), ``csrc/ica_step.cu`` (replaces
``pallas_ica.py:_ica_step_kernel``) and ``csrc/ica_fused.cu`` (replaces
``pallas_ica_fused.py:_ica_kernel``); their source headers say what bounds
each on the H100 and how the design answers it. Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; ``<wrapper>.launches`` counts kernel launches.
"""

import ctypes

import torch

from . import _build

METRICS = {"L1": 0, "L2": 1}


def flow_windows(img, top, left, size, fill=None):
    """Per-tile windows ``img[top + i, left + j]``, ``0 <= i, j < size``.

    ``top``/``left``: integer tensors (ny, nx). ``fill=None`` clamps the
    coordinates to the image (edge semantics); a float fills out-of-bounds
    pixels with that value. Returns (ny, nx, size, size).
    """
    h, w = img.shape
    ar = torch.arange(size, device=img.device)
    rows = top[..., None] + ar
    cols = left[..., None] + ar
    v = img[rows.clamp(0, h - 1)[..., :, None], cols.clamp(0, w - 1)[..., None, :]]
    if fill is not None:
        inb = ((rows >= 0) & (rows < h))[..., :, None] & \
              ((cols >= 0) & (cols < w))[..., None, :]
        v = torch.where(inb, v, torch.full((), fill, dtype=v.dtype, device=v.device))
    return v


def tile_origins(flow_int, tile_size, offset=0):
    """(top, left) of each tile's window: tile origin + integer flow - offset."""
    ny, nx = flow_int.shape[:2]
    dev = flow_int.device
    top = torch.arange(ny, device=dev)[:, None] * tile_size + flow_int[..., 1] - offset
    left = torch.arange(nx, device=dev)[None, :] * tile_size + flow_int[..., 0] - offset
    return top, left


def block_match_plain(ref_tiles, moving, flow, tile_size, radius, metric):
    """Plain version of K1: integer displacement (ny, nx, 2) int32 (dx, dy).

    Windows sit at ``round(flow)`` (half-to-even). L1 fills out-of-bounds
    pixels with 0, L2 clamps coordinates. Costs are summed over the tile in
    row-major order, one elementwise add per pixel, so the kernel reproduces
    them bit for bit; ties go to the first candidate in row-major (sy, sx)
    order.
    """
    ts, r = int(tile_size), int(radius)
    ny, nx = flow.shape[:2]
    n_sh = 2 * r + 1
    top, left = tile_origins(torch.round(flow).long(), ts, r)
    search = flow_windows(moving, top, left, ts + 2 * r,
                          fill=None if metric == "L2" else 0.0)
    zero = torch.zeros((ny, nx, n_sh, n_sh), dtype=moving.dtype,
                       device=moving.device)
    e1, e2 = zero, zero
    for y in range(ts):
        for x in range(ts):
            wv = search[:, :, y:y + n_sh, x:x + n_sh]
            rv = ref_tiles[:, :, y, x, None, None]
            if metric == "L2":
                e1 = e1 + wv * wv
                e2 = e2 + rv * wv
            else:
                e1 = e1 + torch.abs(rv - wv)
    err = e1 - 2.0 * e2 if metric == "L2" else e1
    idx = torch.argmin(err.reshape(ny, nx, n_sh * n_sh), dim=-1)
    return torch.stack([idx % n_sh - r, idx // n_sh - r], dim=-1).to(torch.int32)


def block_match(ref_tiles, moving, flow, tile_size, radius, metric):
    """K1: block-matching displacement (ny, nx, 2) int32 (dx, dy).

    ``ref_tiles``: (ny, nx, ts, ts), any strides (views of the level image
    are fine); ``moving``: (h, w) contiguous; ``flow``: (ny, nx, 2)
    contiguous, (x, y) order. ``metric``: "L1" (zero fill) or "L2" (edge
    clamp).
    """
    ts, r = int(tile_size), int(radius)
    dev = moving.device
    _build.check_arg(metric in METRICS, f"unknown metric {metric}")
    _build.check_f32("moving", moving, 2, dev)
    _build.check_f32("flow", flow, 3, dev)
    _build.check_f32("ref_tiles", ref_tiles, 4, dev)
    ny, nx = flow.shape[:2]
    _build.check_arg(tuple(ref_tiles.shape) == (ny, nx, ts, ts) and flow.shape[2] == 2,
           f"shapes: ref_tiles {tuple(ref_tiles.shape)}, flow {tuple(flow.shape)}")
    if dev.type == "cpu":
        return block_match_plain(ref_tiles, moving, flow, ts, r, metric)
    _build.require_cuda(dev)
    _build.check_arg(moving.is_contiguous() and flow.is_contiguous(),
           "moving and flow must be contiguous")
    _build.check_arg(all(s >= 0 for s in ref_tiles.stride()), "negative ref strides")
    disp = torch.empty((ny, nx, 2), dtype=torch.int32, device=dev)
    lib = _build.library()
    code = lib.hmsr_block_match(
        _build.ptr(ref_tiles), *ref_tiles.stride(), _build.ptr(moving),
        moving.shape[0], moving.shape[1], _build.ptr(flow), ny, nx, ts, r,
        METRICS[metric], _build.ptr(disp), _build.stream_of(moving))
    _build.check(code, "hmsr_block_match")
    block_match.launches += 1
    return disp


block_match.launches = 0


def bm_layout(tile_size, radius, metric, n_tiles):
    """The launch layout of K1 for (ts, r, metric) on a level of ``n_tiles``
    tiles, as the built library computes it: ``fixed`` (an instantiation of
    its own, else the one with run-time ts and r), ``tiles_per_warp``,
    ``lanes_per_tile``, ``threads`` per block, tile rows per staged
    ``band`` and ``smem_bytes`` of dynamic shared memory per block. Needs
    the CUDA toolchain (it builds the library), not a card."""
    out = (ctypes.c_int * 6)()
    _build.check(_build.library().hmsr_bm_layout(int(tile_size), int(radius),
                                                  METRICS[metric], int(n_tiles), out),
                 "hmsr_bm_layout")
    return dict(fixed=bool(out[0]), tiles_per_warp=out[1], lanes_per_tile=out[2],
                threads=out[3], band=out[4], smem_bytes=out[5])


def ica_step_plain(ref_lvl, gradx, grady, moving, flow, tile_size):
    """Plain version of K2: ``b = sum -grad * (warp - ref)`` per tile,
    (ny, nx, 2). Flow split by truncation toward zero; the bilinear
    (ts+1)^2 window reads 0 out of bounds."""
    ts = int(tile_size)
    ny, nx = flow.shape[:2]

    def tiles(a):
        return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)

    ax, ay = flow[..., 0], flow[..., 1]
    ix, iy = torch.trunc(ax), torch.trunc(ay)
    frac_x = (ax - ix)[..., None, None]
    frac_y = (ay - iy)[..., None, None]
    top, left = tile_origins(torch.stack([ix, iy], -1).long(), ts)
    win = flow_windows(moving, top, left, ts + 1, fill=0.0)
    m00 = win[..., :ts, :ts]
    m01 = win[..., :ts, 1:]
    m10 = win[..., 1:, :ts]
    m11 = win[..., 1:, 1:]
    tp = m00 + (m01 - m00) * frac_x
    bt = m10 + (m11 - m10) * frac_x
    interp = tp + (bt - tp) * frac_y
    gradt = interp - tiles(ref_lvl)
    b0 = torch.sum(-tiles(gradx) * gradt, dim=(-2, -1))
    b1 = torch.sum(-tiles(grady) * gradt, dim=(-2, -1))
    return torch.stack([b0, b1], dim=-1)


def solve_terms(hessian):
    """Per-tile terms of the Gauss-Newton solve, (ny, nx, 5) float32:
    ``det_inv, a00, a01, a10, a11`` of the 2x2 Hessian; ``det_inv`` is 0 on
    tiles with ``|det| < 1e-10``, which keep their flow (``prep_ica_pallas``
    encodes the rule the same way)."""
    a00, a01 = hessian[..., 0, 0], hessian[..., 0, 1]
    a10, a11 = hessian[..., 1, 0], hessian[..., 1, 1]
    det = a00 * a11 - a01 * a10
    solvable = torch.abs(det) >= 1e-10
    det_inv = torch.where(solvable, 1.0 / torch.where(solvable, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    return torch.stack([det_inv, a00, a01, a10, a11], dim=-1).to(torch.float32).contiguous()


def gn_update(flow, b, terms):
    """One Gauss-Newton flow update from the right-hand side ``b``."""
    det_inv, a00, a01, a10, a11 = terms.unbind(-1)
    b0, b1 = b[..., 0], b[..., 1]
    dx = det_inv * (a11 * b0 - a01 * b1)
    dy = det_inv * (-a10 * b0 + a00 * b1)
    upd = flow + torch.stack([dx, dy], dim=-1)
    return torch.where((det_inv != 0)[..., None], upd, flow)


def ica_steps_plain(ref_lvl, gradx, grady, terms, moving, flow, tile_size, n_iter):
    """Plain version of K2: ``n_iter`` times :func:`ica_step_plain` and
    :func:`gn_update`; returns the new (ny, nx, 2) flow."""
    fl = flow
    for _ in range(int(n_iter)):
        fl = gn_update(fl, ica_step_plain(ref_lvl, gradx, grady, moving, fl, tile_size),
                       terms)
    return fl


def ica_fused_plain(ref_lvl, gradx, grady, terms, moving, flow, tile_size,
                    n_iter, bm):
    """Plain version of K3: with ``bm``, the L1 radius-1 search of
    :func:`block_match_plain` and the flow replaced by ``round(flow) + d``;
    then :func:`ica_steps_plain`."""
    ts = int(tile_size)
    ny, nx = flow.shape[:2]
    fl = flow
    if bm:
        tiles = ref_lvl[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)
        fl = torch.round(fl)
        fl = fl + block_match_plain(tiles, moving, fl, ts, 1, "L1").to(fl.dtype)
    return ica_steps_plain(ref_lvl, gradx, grady, terms, moving, fl, ts, n_iter)


def _check_gn_operands(ref_lvl, gradx, grady, terms, moving, flow, ts):
    """Argument checks shared by K2 and K3; returns (device, ny, nx)."""
    dev = moving.device
    for name, t in (("ref_lvl", ref_lvl), ("gradx", gradx), ("grady", grady),
                    ("moving", moving)):
        _build.check_f32(name, t, 2, dev)
    _build.check_f32("flow", flow, 3, dev)
    _build.check_f32("terms", terms, 3, dev)
    ny, nx = flow.shape[:2]
    _build.check_arg(ref_lvl.shape == gradx.shape == grady.shape,
                     "ref_lvl, gradx and grady must share a shape")
    _build.check_arg(ny * ts <= ref_lvl.shape[0] and nx * ts <= ref_lvl.shape[1]
                     and flow.shape[2] == 2 and tuple(terms.shape) == (ny, nx, 5),
                     f"flow {tuple(flow.shape)}, terms {tuple(terms.shape)} do not "
                     f"fit level {tuple(ref_lvl.shape)}")
    if dev.type != "cpu":
        _build.require_cuda(dev)
        _build.check_arg(all(t.is_contiguous() for t in (ref_lvl, gradx, grady, moving,
                                                          flow, terms)),
                         "Gauss-Newton operands must be contiguous")
    return dev, ny, nx


def _gn_args(ref_lvl, gradx, grady, terms, moving, flow):
    return (_build.ptr(ref_lvl), _build.ptr(gradx), _build.ptr(grady),
            ref_lvl.shape[1], _build.ptr(moving), moving.shape[0], moving.shape[1],
            _build.ptr(flow), _build.ptr(terms))


def ica_steps(ref_lvl, gradx, grady, terms, moving, flow, tile_size, n_iter):
    """K2: ``n_iter`` Gauss-Newton steps of every tile of a level in one
    launch, the 2x2 solve included; returns the new (ny, nx, 2) flow.

    ``ref_lvl``, ``gradx``, ``grady``: the reference level and its gradients,
    same shape, contiguous; tiles are carved from their top-left
    ``ny*ts x nx*ts`` region. ``terms``: (ny, nx, 5) from
    :func:`solve_terms`; ``moving``: (h, w); ``flow``: (ny, nx, 2); all
    contiguous.
    """
    ts = int(tile_size)
    dev, ny, nx = _check_gn_operands(ref_lvl, gradx, grady, terms, moving, flow, ts)
    if dev.type == "cpu":
        return ica_steps_plain(ref_lvl, gradx, grady, terms, moving, flow, ts, n_iter)
    out = torch.empty((ny, nx, 2), dtype=torch.float32, device=dev)
    code = _build.library().hmsr_ica_steps(
        *_gn_args(ref_lvl, gradx, grady, terms, moving, flow), ny, nx, ts,
        int(n_iter), _build.ptr(out), _build.stream_of(moving))
    _build.check(code, "hmsr_ica_steps")
    ica_steps.launches += 1
    return out


ica_steps.launches = 0


def ica_fused(ref_lvl, gradx, grady, terms, moving, flow, tile_size, n_iter,
              bm):
    """K3: ``n_iter`` Gauss-Newton steps per tile in one launch, after an L1
    radius-1 block-matching search when ``bm``; returns the new (ny, nx, 2)
    flow. Operands as for :func:`ica_steps`.
    """
    ts = int(tile_size)
    dev, ny, nx = _check_gn_operands(ref_lvl, gradx, grady, terms, moving, flow, ts)
    if dev.type == "cpu":
        return ica_fused_plain(ref_lvl, gradx, grady, terms, moving, flow, ts,
                               n_iter, bm)
    out = torch.empty((ny, nx, 2), dtype=torch.float32, device=dev)
    code = _build.library().hmsr_ica_fused(
        *_gn_args(ref_lvl, gradx, grady, terms, moving, flow), ny, nx, ts,
        int(n_iter), int(bool(bm)), _build.ptr(out), _build.stream_of(moving))
    _build.check(code, "hmsr_ica_fused")
    ica_fused.launches += 1
    return out


ica_fused.launches = 0


def ica_layout(tile_size, fused, bm=False):
    """The launch layout of K2 (``fused`` False) or K3 (with its search when
    ``bm``) at ``tile_size``, as the built library computes it: ``fixed``
    (an instantiation of its own, else the one with run-time ts),
    ``tiles_per_block``, ``lanes_per_tile``, ``threads`` per block and
    ``smem_bytes`` of dynamic shared memory per block. Needs the CUDA
    toolchain (it builds the library), not a card."""
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().hmsr_ica_layout(int(tile_size), int(bool(fused)),
                                                   int(bool(bm)), out),
                 "hmsr_ica_layout")
    return dict(fixed=bool(out[0]), tiles_per_block=out[1], lanes_per_tile=out[2],
                threads=out[3], smem_bytes=out[4])
