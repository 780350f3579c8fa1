"""K8 (the raw burst's normalization) and K9 (MIPI RAW10/RAW12 unpacking):
CUDA kernel wrappers and their plain PyTorch versions.

Counterparts of the JAX package's host loader
``hmsr_tpu/io/native_loader.py``: ``normalize_burst`` (K8) and
``unpack_raw10`` / ``unpack_raw12`` (K9), whose C++ is
``native/burst_loader.cpp``. The kernels are in ``csrc/ingest.cu``, whose
header says what bounds them and how the design answers it. K8 takes the
per-CFA-phase ``(black, gain)`` pairs that
:func:`hmsr_tpu_torch.io.native_loader.normalize_burst` computes on the host
in numpy float32, and rounds its subtract and its multiply once each, so it
equals the plain version (and numpy) bit for bit. A wrapper launches its
kernel for CUDA tensors and runs the plain version only for CPU tensors;
``normalize_bayer.launches`` and ``unpack_raw.launches`` count kernel
launches.
"""

import torch

from . import _build

#: K9's packed formats: bits per pixel -> (pixels, bytes) per group
RAW_FORMATS = {10: (4, 5), 12: (2, 3)}


def phase_pairs(cfa, black, gain):
    """``[(black, gain)]`` of the four CFA phases (row-major 2x2), as Python
    floats (exact float32 values): ``cfa`` 4 channel ids, ``black`` and
    ``gain`` float32 arrays indexed by channel."""
    return [(float(black[int(c)]), float(gain[int(c)])) for c in cfa]


def normalize_bayer_plain(frames, cfa, black, gain):
    """Plain version of K8: per 2x2 phase slice, a float32 subtract of the
    phase's black level, then a multiply by its gain (no division)."""
    out = torch.empty(frames.shape, dtype=torch.float32, device=frames.device)
    pairs = phase_pairs(cfa, black, gain)
    for i in range(2):
        for j in range(2):
            b, g = (torch.tensor(v, dtype=torch.float32, device=frames.device)
                    for v in pairs[2 * i + j])
            out[:, i::2, j::2] = (frames[:, i::2, j::2].to(torch.float32) - b) * g
    return out


def normalize_bayer(frames, cfa, black, gain):
    """K8: the uint16 ``(n, h, w)`` raw stack -> float32 ``(n, h, w)`` on its
    device, ``(in - black[c]) * gain[c]`` with ``c = cfa[2 * (y & 1) + (x &
    1)]``; ``black`` and ``gain`` float32 per channel. One launch for the
    whole stack."""
    _build.check_arg(frames.dtype == torch.uint16 and frames.dim() == 3,
                     f"raw stack must be uint16 (n, h, w), got {frames.dtype} "
                     f"{tuple(frames.shape)}")
    _build.check_arg(len(cfa) == 4, f"cfa needs 4 entries, got {len(cfa)}")
    if frames.device.type == "cpu":
        return normalize_bayer_plain(frames, cfa, black, gain)
    _build.require_cuda(frames.device)
    frames = frames.contiguous()
    n, h, w = frames.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=frames.device)
    if out.numel() == 0:
        return out
    pairs = [v for pair in phase_pairs(cfa, black, gain) for v in pair]
    code = _build.library().hmsr_normalize_bayer(
        _build.ptr(frames), _build.ptr(out), n, h, w, *pairs, _build.stream_of(frames))
    _build.check(code, "hmsr_normalize_bayer")
    normalize_bayer.launches += 1
    return out


normalize_bayer.launches = 0


def _groups(packed, n_pixels, bits):
    _build.check_arg(bits in RAW_FORMATS, f"no MIPI RAW{bits} format")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed bytes must be uint8, got {packed.dtype}")
    per_group, group_bytes = RAW_FORMATS[bits]
    groups = n_pixels // per_group
    if packed.numel() < groups * group_bytes:
        raise ValueError(f"{packed.numel()} bytes hold fewer than {n_pixels} pixels")
    return groups, per_group, group_bytes


def unpack_raw_plain(packed, n_pixels, bits):
    """Plain version of K9 on the packed bytes' device, in int32 (torch has
    no shifts on uint16): the high 8 bits of pixel k are byte k of its
    group, its low ``bits - 8`` bits sit at bit ``(bits - 8) * k`` of the
    group's last byte."""
    groups, per_group, group_bytes = _groups(packed, n_pixels, bits)
    low = bits - 8
    p = packed.reshape(-1)[:groups * group_bytes].reshape(groups, group_bytes).to(
        torch.int32)
    out = torch.stack([(p[:, k] << low) | ((p[:, per_group] >> (low * k))
                                           & ((1 << low) - 1))
                       for k in range(per_group)], dim=1)
    return out.reshape(-1).to(torch.uint16)


def unpack_raw10_plain(packed, n_pixels):
    """Plain MIPI RAW10: 4 pixels in 5 bytes."""
    return unpack_raw_plain(packed, n_pixels, 10)


def unpack_raw12_plain(packed, n_pixels):
    """Plain MIPI RAW12: 2 pixels in 3 bytes."""
    return unpack_raw_plain(packed, n_pixels, 12)


def unpack_raw(packed, n_pixels, bits):
    """K9: MIPI RAW``bits`` (10 or 12) packed bytes, a uint8 tensor, ->
    ``n_pixels // per_group * per_group`` uint16 pixels on its device (bytes
    past the last whole group are not read)."""
    groups, per_group, _ = _groups(packed, n_pixels, bits)
    _build.check_arg(groups < 2**31, f"{groups} groups: more than a C int holds")
    if packed.device.type == "cpu":
        return unpack_raw_plain(packed, n_pixels, bits)
    _build.require_cuda(packed.device)
    packed = packed.reshape(-1).contiguous()
    out = torch.empty(groups * per_group, dtype=torch.uint16, device=packed.device)
    if groups == 0:
        return out
    code = _build.library().hmsr_unpack_raw(_build.ptr(packed), _build.ptr(out), groups,
                                            bits, _build.stream_of(packed))
    _build.check(code, "hmsr_unpack_raw")
    unpack_raw.launches += 1
    return out


unpack_raw.launches = 0
