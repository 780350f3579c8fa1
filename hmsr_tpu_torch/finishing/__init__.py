from .device import gaussian_blur_nearest, make_postprocess_device
from .orientation import apply_orientation
from .raw2rgb import get_color_matrix, postprocess

__all__ = ["apply_orientation", "get_color_matrix", "gaussian_blur_nearest",
           "make_postprocess_device", "postprocess"]
