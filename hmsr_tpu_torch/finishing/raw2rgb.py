"""The host finishing chain (twin of :mod:`hmsr_tpu.finishing.raw2rgb`), in
numpy, scipy and OpenCV.

The JAX package runs this chain on the host by design: its tone mapping is
OpenCV's Mertens exposure fusion (``cv2.createMergeMertens``), which has no
device form. ``process_burst`` takes it for ``tpu.finishing_impl="host"``,
and for ``"auto"`` with tonemapping where cv2 imports; the image leaves the
card once. The chain of every other configuration runs on the card:
:mod:`hmsr_tpu_torch.finishing.device`.

cv2 is optional: without it :func:`apply_smoothstep` warns and applies the
plain smoothstep, as the JAX package does.
"""

import warnings

import numpy as np
from scipy.ndimage import gaussian_filter

RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                    [0.2126729, 0.7151522, 0.0721750],
                    [0.0193339, 0.1191920, 0.9503041]])


def get_color_matrix(xyz2cam=None):
    """Row-normalized RGB -> camera CCM from an xyz2cam matrix, float32."""
    if xyz2cam is None or np.linalg.norm(xyz2cam) == 0:
        print("Warning -- CCM not found or given. Use eye matrix instead.")
        rgb2cam = RGB2XYZ
    else:
        rgb2cam = np.asarray(xyz2cam)[:3] @ RGB2XYZ
    rgb2cam = rgb2cam / rgb2cam.sum(axis=-1, keepdims=True)
    return rgb2cam.astype(np.float32)


def apply_ccm(image, ccm):
    """``ccm @ pixel`` for every pixel of an (H, W, 3) image."""
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    return np.einsum("ij,hwj->hwi", ccm, image)


def gamma_compression(img, gamma=2.2):
    return np.clip(img, 0.0, 1.0) ** (1.0 / gamma)


def unsharp_mask(img, radius, amount):
    """Per-channel unsharp mask, ``skimage.filters.unsharp_mask``'s
    definition: Gaussian blur of sigma ``radius`` with the nearest boundary,
    ``img + amount * (img - blurred)``."""
    blurred = np.stack([gaussian_filter(img[..., c], sigma=radius, mode="nearest")
                        for c in range(img.shape[-1])], -1)
    return img + amount * (img - blurred)


def apply_smoothstep(image):
    """Mertens exposure fusion of the image at exposures 1, 0.5 and 2, then
    the smoothstep ``3x^2 - 2x^3``; without cv2, a warning and the plain
    smoothstep of the clipped image."""
    try:
        import cv2
    except ImportError:
        warnings.warn("cv2 unavailable; falling back to plain smoothstep tonemap")
        image = np.clip(image, 0.0, 1.0)
        return 3 * image ** 2 - 2 * image ** 3
    times = [1, 0.5, 2]
    images = [(np.clip(image * t, 0, 1) * 255).astype(np.uint8) for t in times]
    out = cv2.createMergeMertens().process(images).astype(np.float32)
    return 3 * out ** 2 - 2 * out ** 3


def devignette(image):
    """Inverse cos^4 vignetting model."""
    h, w, _ = image.shape
    vf = np.abs(np.linspace(-h / w * np.pi / 2, h / w * np.pi / 2, h))
    vf = np.outer(vf, np.abs(np.linspace(-np.pi / 2, np.pi / 2, w)))
    return (2 - np.cos(vf) ** 4)[:, :, None] * image


def postprocess(img, do_color_correction=True, do_tonemapping=True,
                do_gamma=True, sharpening_config=None, do_devignette=False,
                xyz2cam=None):
    """The finishing chain on the merged linear image, an (H, W, 3) numpy
    array: colour correction, unsharp mask, devignetting, tone mapping and
    gamma, each clipped to [0, 1] as in the JAX package."""
    img = np.asarray(img, dtype=np.float32)
    if do_color_correction:
        cam2rgb = np.linalg.inv(get_color_matrix(xyz2cam))
        img = np.clip(apply_ccm(img, cam2rgb), 0.0, 1.0)
    if sharpening_config is not None and sharpening_config.get("enabled", False):
        img = unsharp_mask(img, radius=sharpening_config.get("radius", 3),
                           amount=sharpening_config.get("amount", 0.5))
    if do_devignette:
        img = devignette(img)
    if do_tonemapping:
        img = apply_smoothstep(img)
    img = np.clip(img, 0.0, 1.0)
    if do_gamma:
        img = gamma_compression(img)
    return np.clip(img, 0.0, 1.0)
