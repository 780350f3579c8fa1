"""Alignment of the plain reference: the FFT grey image, the Gaussian
pyramid, integer block matching and the inverse-compositional Gauss-Newton
refinement, coarse to fine (Wronski et al. 2019, Algs. 2-3; the reference
implementation's ``block_matching.py`` and ``ICA.py``), in plain torch.

Flow conventions: (ny, nx, 2) per tile in (x, y) order. Search windows sit at
``round(flow)`` (half to even); L2 clamps coordinates to the image and adds
the displacement to the unrounded flow, L1 fills out-of-bounds pixels with
0 and replaces the flow by ``round(flow) + d``; costs are summed over a tile
in row-major order, ties go to the first candidate.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def _lowpass_mask(h, w):
    my = np.ones((h, 1), dtype=np.float32)
    mx = np.ones((1, w), dtype=np.float32)
    my[: h // 4] = 0.0
    my[-h // 4:] = 0.0
    mx[:, : w // 4] = 0.0
    mx[:, -w // 4:] = 0.0
    return my * mx


@functools.lru_cache(maxsize=2)
def _half_plane_mask(h, w, device):
    m = np.fft.ifftshift(_lowpass_mask(h, w))
    m_sym = 0.5 * (m + m[np.ix_((-np.arange(h)) % h, (-np.arange(w)) % w)])
    return torch.as_tensor(m_sym[:, : w // 2 + 1].astype(np.float32), device=device)


def grey_fft(img):
    """Low-pass grey image of a raw frame by spectral masking (Alg. 3)."""
    h, w = img.shape
    spec = torch.fft.rfft2(img.to(F32))
    return torch.fft.irfft2(spec * _half_plane_mask(h, w, img.device), s=(h, w)).to(F32)


def _gauss_taps(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float32)


def _downsample(img, factor):
    if factor == 1:
        return img
    radius = int(4 * factor * 0.5 + 0.5)
    taps = [float(t) for t in _gauss_taps(factor * 0.5, radius)]
    h, w = img.shape
    h2, w2 = (h - 2 * radius) // factor, (w - 2 * radius) // factor
    out = None
    for t, tap in enumerate(taps):
        v = img[t:t + (h2 - 1) * factor + 1:factor, :]
        out = tap * v if out is None else out + tap * v
    out2 = None
    for t, tap in enumerate(taps):
        v = out[:, t:t + (w2 - 1) * factor + 1:factor]
        out2 = tap * v if out2 is None else out2 + tap * v
    return out2


def pyramid(img, factors):
    """Coarse-first Gaussian pyramid."""
    levels = [_downsample(img, factors[0])]
    for f in factors[1:]:
        levels.append(_downsample(levels[-1], f))
    return levels[::-1]


def _tiles(a, ts, ny, nx):
    return a[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)


def _windows(img, top, left, size, fill=None):
    h, w = img.shape
    ar = torch.arange(size, device=img.device)
    rows, cols = top[..., None] + ar, left[..., None] + ar
    v = img[rows.clamp(0, h - 1)[..., :, None], cols.clamp(0, w - 1)[..., None, :]]
    if fill is not None:
        inb = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
        v = torch.where(inb, v, torch.full((), fill, dtype=v.dtype, device=v.device))
    return v


def _origins(flow_int, ts, offset=0):
    ny, nx = flow_int.shape[:2]
    dev = flow_int.device
    top = torch.arange(ny, device=dev)[:, None] * ts + flow_int[..., 1] - offset
    left = torch.arange(nx, device=dev)[None, :] * ts + flow_int[..., 0] - offset
    return top, left


def block_match(ref_tiles, moving, flow, ts, r, metric):
    """Integer displacement (ny, nx, 2) (dx, dy) of the least cost."""
    ny, nx = flow.shape[:2]
    n_sh = 2 * r + 1
    top, left = _origins(torch.round(flow).long(), ts, r)
    search = _windows(moving, top, left, ts + 2 * r, fill=None if metric == "L2" else 0.0)
    e1 = e2 = torch.zeros((ny, nx, n_sh, n_sh), dtype=moving.dtype, device=moving.device)
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


def _sobel(img):
    px = F.pad(img, (1, 1, 0, 0))
    py = F.pad(img, (0, 0, 1, 1))
    return px[:, 2:] - px[:, :-2], py[2:, :] - py[:-2, :]


def _ica_level(lvl, ts):
    """Gradients and the solve terms (det_inv, a00, a01, a10, a11) of each
    tile's Hessian; det_inv is 0 where |det| < 1e-10 (the tile keeps its
    flow)."""
    ny, nx = lvl.shape[0] // ts, lvl.shape[1] // ts
    gx, gy = _sobel(lvl)
    tx, ty = _tiles(gx, ts, ny, nx), _tiles(gy, ts, ny, nx)
    a00 = torch.sum(tx * tx, dim=(-2, -1))
    a01 = torch.sum(tx * ty, dim=(-2, -1))
    a11 = torch.sum(ty * ty, dim=(-2, -1))
    a10 = a01
    det = a00 * a11 - a01 * a10
    ok = torch.abs(det) >= 1e-10
    det_inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    return gx, gy, (det_inv, a00, a01, a10, a11)


def _gn_rhs(lvl, gx, gy, moving, flow, ts):
    ny, nx = flow.shape[:2]
    ax, ay = flow[..., 0], flow[..., 1]
    ix, iy = torch.trunc(ax), torch.trunc(ay)
    frac_x, frac_y = (ax - ix)[..., None, None], (ay - iy)[..., None, None]
    top, left = _origins(torch.stack([ix, iy], -1).long(), ts)
    win = _windows(moving, top, left, ts + 1, fill=0.0)
    m00, m01 = win[..., :ts, :ts], win[..., :ts, 1:]
    m10, m11 = win[..., 1:, :ts], win[..., 1:, 1:]
    tp = m00 + (m01 - m00) * frac_x
    bt = m10 + (m11 - m10) * frac_x
    gradt = (tp + (bt - tp) * frac_y) - _tiles(lvl, ts, ny, nx)
    b0 = torch.sum(-_tiles(gx, ts, ny, nx) * gradt, dim=(-2, -1))
    b1 = torch.sum(-_tiles(gy, ts, ny, nx) * gradt, dim=(-2, -1))
    return b0, b1


def _gn_steps(lvl, state, moving, flow, ts, n_iter):
    gx, gy, (det_inv, a00, a01, a10, a11) = state
    for _ in range(n_iter):
        b0, b1 = _gn_rhs(lvl, gx, gy, moving, flow, ts)
        dx = det_inv * (a11 * b0 - a01 * b1)
        dy = det_inv * (-a10 * b0 + a00 * b1)
        upd = flow + torch.stack([dx, dy], dim=-1)
        flow = torch.where((det_inv != 0)[..., None], upd, flow)
    return flow


class Aligner:
    """The reference frame's pyramid and Gauss-Newton state, and the
    coarse-to-fine flow of a compared grey image against it."""

    def __init__(self, ref_grey, tuning, n_iter):
        self.t, self.n_iter = tuning, n_iter
        Ts = tuning["tile_size"]
        h, w = ref_grey.shape
        pb, pr = (Ts - h % Ts) % Ts, (Ts - w % Ts) % Ts
        rows = torch.arange(h + pb, device=ref_grey.device) % h
        cols = torch.arange(w + pr, device=ref_grey.device) % w
        padded = ref_grey[rows[:, None], cols[None, :]]
        n = len(tuning["factors"])
        # (factor, tile size, radius, metric) per level, coarse first
        self.levels = [(tuning["factors"][n - l - 1], tuning["tile_sizes"][n - l - 1],
                        tuning["search_radii"][n - l - 1], tuning["metrics"][n - l - 1])
                       for l in range(n)]
        self.pyr = [lvl.contiguous() for lvl in pyramid(padded, tuning["factors"])]
        self.ica = [_ica_level(lvl, ts) for lvl, (_, ts, _, _) in zip(self.pyr, self.levels)]

    def _upscale(self, flow, npatches, list_id):
        t = self.t
        new_ts, prev_ts = t["tile_sizes"][list_id], t["tile_sizes"][list_id + 1]
        factor = t["factors"][list_id + 1]
        repeat = factor // (new_ts // prev_ts)
        if t["flow_upscale_mode"] != "nearest":
            raise ValueError("the reference upscales flows by the nearest rule only")
        up = flow if repeat == 1 else \
            flow.repeat_interleave(repeat, dim=0).repeat_interleave(repeat, dim=1)
        up = up * float(factor)
        ny, nx = npatches
        if up.shape[0] < ny or up.shape[1] < nx:
            up = F.pad(up, (0, 0, 0, nx - up.shape[1], 0, ny - up.shape[0]))
        return up

    def flow(self, moving_grey):
        mov = pyramid(moving_grey, self.t["factors"])
        n = len(self.levels)
        flow = None
        for l, (_, ts, r, metric) in enumerate(self.levels):
            lvl = self.pyr[l]
            npatches = (lvl.shape[0] // ts, lvl.shape[1] // ts)
            if flow is None:
                flow = torch.zeros((*npatches, 2), dtype=F32, device=lvl.device)
            else:
                flow = self._upscale(flow, npatches, n - l - 1)
            m = mov[l].contiguous()
            tiles = _tiles(lvl, ts, *npatches)
            if metric == "L2":
                flow = flow + block_match(tiles, m, flow, ts, r, "L2").to(flow.dtype)
            else:
                s_flow = torch.round(flow)
                flow = s_flow + block_match(tiles, m, s_flow, ts, r, "L1").to(flow.dtype)
            flow = _gn_steps(lvl, self.ica[l], m, flow.to(F32), ts, self.n_iter)
        return flow
