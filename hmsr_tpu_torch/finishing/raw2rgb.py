"""The colour matrix of the finishing chain (``get_color_matrix`` of
:mod:`hmsr_tpu.finishing.raw2rgb`).

The host chain of that module (``postprocess``, with OpenCV's Mertens
exposure fusion) is not ported; the device chain is
:mod:`hmsr_tpu_torch.finishing.device`.
"""

import numpy as np

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
