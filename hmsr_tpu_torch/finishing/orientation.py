"""EXIF orientation (8 cases) on device tensors (twin of
:mod:`hmsr_tpu.finishing.orientation`): the same flips and ``rot90`` turns,
with the same ``k`` and axes as ``np.rot90``.
"""

import torch


def apply_orientation(img, ori):
    """Orient an (H, W, ...) tensor as EXIF orientation ``ori`` says."""
    if ori == 2:        # mirrored horizontal
        img = torch.flip(img, dims=(1,))
    elif ori == 3:      # rotate 180
        img = torch.rot90(img, k=2, dims=(0, 1))
    elif ori == 4:      # mirror vertical
        img = torch.flip(img, dims=(0,))
    elif ori == 5:      # mirror horizontal + rotate 270 CW
        img = torch.rot90(torch.flip(img, dims=(1,)), k=-3, dims=(0, 1))
    elif ori == 6:      # rotate 90 CW
        img = torch.rot90(img, k=-1, dims=(0, 1))
    elif ori == 7:      # mirror horizontal + rotate 90 CW
        img = torch.rot90(torch.flip(img, dims=(1,)), k=-1, dims=(0, 1))
    elif ori == 8:      # rotate 270 CW
        img = torch.rot90(img, k=-3, dims=(0, 1))
    return img
