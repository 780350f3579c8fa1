"""Raw burst ingestion (twin of :mod:`hmsr_tpu.io.burst`).

- a folder of ``*.dng`` (reference frame = index 0), read with ``rawpy`` and
  ``exifread``: ISO (clipped to [100, 3200]), CFA pattern with both greens
  mapped to channel 1, white/black levels, white balance, xyz2cam CCM, the
  DNG noise profile tag 0xC761, orientation; per-CFA-channel black-level
  subtraction, normalisation to [0, 1] and white-balance gains relative to
  green, on the device (:mod:`.native_loader`: K8 on the card);
- or a ``.npz`` bundle carrying the same fields (:func:`save_npz_burst`).

``rawpy``/``exifread`` are optional: without them the DNG branch raises
``ImportError``, and bursts come from ``.npz`` bundles or are passed as
arrays to :func:`hmsr_tpu_torch.models.process.process_arrays`.
"""

import glob
import os
import warnings
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.types import resolve_device
from .native_loader import normalize_burst


class Burst(NamedTuple):
    ref_raw: object                # (H, W) float32 in [0, 1], WB applied
    comp_raws: object              # (N-1, H, W); numpy arrays or tensors
    iso: int
    cfa: np.ndarray                # (2, 2) int, greens = 1
    xyz2cam: Optional[np.ndarray]  # (3, 3) or None
    white_balance: list            # per-channel gains
    noise_alpha: Optional[float]   # from DNG tag 0xC761 when present
    noise_beta: Optional[float]
    orientation: int
    ref_path: Optional[str]


def load_burst(burst_path, mode="bayer", device="cuda"):
    """Load a burst from a folder of DNGs (normalized on ``device``) or a
    .npz bundle (its frames as stored, numpy)."""
    p = Path(burst_path)
    if p.suffix == ".npz" or (p.is_file() and p.suffix == ".npy"):
        return load_npz_burst(p)
    if p.is_dir() and glob.glob(os.path.join(p.as_posix(), "*.npz")):
        return load_npz_burst(glob.glob(os.path.join(p.as_posix(), "*.npz"))[0])
    return load_dng_burst(p, mode=mode, device=device)


def load_npz_burst(path):
    """Burst bundle: frames (N, H, W) raw floats + metadata arrays."""
    with np.load(path, allow_pickle=False) as data:
        frames = data["frames"].astype(np.float32)
        cfa = data["cfa"] if "cfa" in data else np.array([[0, 1], [1, 2]])
        wb = list(data["white_balance"]) if "white_balance" in data \
            else [1.0, 1.0, 1.0, 1.0]
        iso = int(data["iso"]) if "iso" in data else 100
        alpha = float(data["alpha"]) if "alpha" in data else None
        beta = float(data["beta"]) if "beta" in data else None
        xyz2cam = data["xyz2cam"].astype(np.float32) if "xyz2cam" in data else None
        ori = int(data["orientation"]) if "orientation" in data else 1
    return Burst(ref_raw=frames[0], comp_raws=frames[1:], iso=iso,
                 cfa=np.asarray(cfa, np.int64), xyz2cam=xyz2cam,
                 white_balance=wb, noise_alpha=alpha, noise_beta=beta,
                 orientation=ori, ref_path=None)


def load_dng_burst(burst_path, mode="bayer", device="cuda"):
    """Folder of .dng files -> Burst (requires rawpy + exifread). Integer
    frames are copied to ``device`` as uint16 one by one as they are read,
    then normalized there (K8 on the card,
    :func:`.native_loader.normalize_burst`): ``ref_raw`` and ``comp_raws``
    are float32 tensors on ``device``. Float frames stay numpy, as read."""
    try:
        import exifread
        import rawpy
    except ImportError:
        raise ImportError(
            "rawpy/exifread are required for DNG ingestion but are not "
            "installed. Package the burst as a .npz bundle (frames, cfa, "
            "white_balance, iso, alpha, beta) or pass arrays directly to "
            "process_arrays().") from None

    burst_path = Path(burst_path)
    raw_path_list = sorted(glob.glob(os.path.join(burst_path.as_posix(), "*.dng")))
    if not raw_path_list:
        raise ValueError("At least one raw .dng file must be present in the "
                         "burst folder.")

    with rawpy.imread(raw_path_list[0]) as raw:
        ref_raw = raw.raw_image.copy()
        white_level = int(raw.white_level)
        black_levels = raw.black_level_per_channel
        white_balance = raw.camera_whitebalance
        cfa = raw.raw_pattern.copy()
    cfa[cfa == 3] = 1       # both greens -> channel 1

    stack = None
    if np.issubdtype(ref_raw.dtype, np.integer):
        # integer frames go to the device as uint16 as they are read: the
        # host holds no stack of them
        stack = torch.empty((len(raw_path_list), *ref_raw.shape), dtype=torch.uint16,
                            device=resolve_device(device))
        stack[0].copy_(_uint16(ref_raw, ref_raw.shape, raw_path_list[0]))
        for i, raw_path in enumerate(raw_path_list[1:], 1):
            with rawpy.imread(raw_path) as raw_obj:
                stack[i].copy_(_uint16(raw_obj.raw_image, ref_raw.shape, raw_path))
    else:
        raw_comp = []
        for raw_path in raw_path_list[1:]:
            with rawpy.imread(raw_path) as raw_obj:
                raw_comp.append(raw_obj.raw_image.copy())
        raw_comp = np.array(raw_comp)

    with open(raw_path_list[0], "rb") as f:
        tags = exifread.process_file(f)

    xyz2cam = None          # ColorMatrix1 (tag 0xC621)
    if "Image Tag 0xC621" in tags:
        vals = np.array([x.decimal() for x in tags["Image Tag 0xC621"].values])
        xyz2cam = vals.reshape(3, 3).astype(np.float32)

    if "EXIF ISOSpeedRatings" in tags:
        iso = int(str(tags["EXIF ISOSpeedRatings"]))
    elif "Image ISOSpeedRatings" in tags:
        iso = int(str(tags["Image ISOSpeedRatings"]))
    else:
        raise AttributeError("ISO value could not be found in both EXIF and Image type.")
    iso = int(np.clip(iso, 100, 3200))

    alpha = beta = None     # DNG NoiseProfile tag 0xC761 (scaled for the ISO)
    if "Image Tag 0xC761" in tags:
        vals = tags["Image Tag 0xC761"].values
        if mode == "grey":
            alpha = float(vals[0][0])
            beta = float(vals[1][0])
        else:
            alpha = float(sum(x[0] for x in vals[::2]) / 3)
            beta = float(sum(x[0] for x in vals[1::2]) / 3)

    orientation = 1
    if "Image Orientation" in tags:
        orientation = tags["Image Orientation"].values[0]
    else:
        warnings.warn("The Image Orientation EXIF tag could not be found. "
                      "The image may be mirrored or misoriented.")

    if stack is not None:
        norm = normalize_burst(stack, cfa, black_levels, white_level, white_balance,
                               device=device)
        ref_raw, raw_comp = norm[0], norm[1:]
    else:
        warnings.warn("Input DNG images are not in integer format: is the "
                      "input valid RAW data?")

    return Burst(ref_raw=ref_raw, comp_raws=raw_comp, iso=iso,
                 cfa=np.asarray(cfa, np.int64), xyz2cam=xyz2cam,
                 white_balance=list(white_balance), noise_alpha=alpha,
                 noise_beta=beta, orientation=orientation,
                 ref_path=raw_path_list[0])


def _uint16(image, shape, path):
    """A decoded frame as a uint16 CPU tensor (no copy when it is one)."""
    if image.shape != shape:
        raise ValueError(f"{path}: frame of shape {image.shape}, the reference's is "
                         f"{shape}")
    return torch.from_numpy(np.ascontiguousarray(image, dtype=np.uint16))


def save_npz_burst(path, frames, cfa, white_balance, iso=100, alpha=None,
                   beta=None, xyz2cam=None, orientation=1):
    """Write a burst bundle loadable by :func:`load_npz_burst`."""
    payload = dict(frames=np.asarray(frames, np.float32),
                   cfa=np.asarray(cfa), white_balance=np.asarray(white_balance),
                   iso=iso, orientation=orientation)
    if alpha is not None:
        payload["alpha"] = alpha
        payload["beta"] = beta
    if xyz2cam is not None:
        payload["xyz2cam"] = np.asarray(xyz2cam)
    np.savez_compressed(path, **payload)
