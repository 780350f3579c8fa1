"""MIPI RAW10 and RAW12 unpacking in torch, on the device of the packed
bytes (twin of ``unpack_raw10`` / ``unpack_raw12`` in
:mod:`hmsr_tpu.io.native_loader`, whose numpy path gives the same values).

RAW10 packs 4 pixels in 5 bytes: the 8 high bits of each, then a byte of
their 2 low bits (pixel k at bits 2k). RAW12 packs 2 pixels in 3 bytes: the
8 high bits of each, then a byte of their 4 low bits (pixel 0 low nibble).
torch has no shifts on uint16, so the arithmetic is int32 and the result is
cast to ``torch.uint16``.
"""

import torch


def _groups(packed, n_pixels, per_group, group_bytes):
    packed = torch.as_tensor(packed)
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed bytes must be uint8, got {packed.dtype}")
    groups = n_pixels // per_group
    if packed.numel() < groups * group_bytes:
        raise ValueError(f"{packed.numel()} bytes hold fewer than {n_pixels} pixels")
    return packed.reshape(-1)[:groups * group_bytes].reshape(groups, group_bytes).to(
        torch.int32)


def unpack_raw10(packed, n_pixels):
    """MIPI RAW10 packed bytes (uint8) -> ``n_pixels`` uint16 pixels
    (``n_pixels`` a multiple of 4)."""
    p = _groups(packed, n_pixels, 4, 5)
    out = torch.stack([(p[:, k] << 2) | ((p[:, 4] >> (2 * k)) & 0x3)
                       for k in range(4)], dim=1)
    return out.reshape(-1).to(torch.uint16)


def unpack_raw12(packed, n_pixels):
    """MIPI RAW12 packed bytes (uint8) -> ``n_pixels`` uint16 pixels
    (``n_pixels`` a multiple of 2)."""
    p = _groups(packed, n_pixels, 2, 3)
    out = torch.stack([(p[:, 0] << 4) | (p[:, 2] & 0xF),
                       (p[:, 1] << 4) | (p[:, 2] >> 4)], dim=1)
    return out.reshape(-1).to(torch.uint16)
