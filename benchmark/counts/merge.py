"""The work of the merge stage, counted from the shapes alone, so that it reads
the same whoever implements it: every compared frame and the reference
frame accumulated at every output pixel, then the refill and divide.

Operations per output pixel and frame (9 taps, steerable kernel): per tap 8
for the quadratic form, 1 exponential, 2 for the weight, 2 to accumulate;
25 for the covariance interpolation and the 2x2 inverse. The reference
frame's taps reach ``rad_max`` with the accumulated-robustness denoiser,
with one more division per tap. The divide is one operation per output
value. Bytes: each input read once (frames, robustness maps, flows,
covariances, the reference frame and its covariances, the accumulated
robustness where the denoiser reads it) and the image written once, in
float32.
"""

F32 = 4


def frame_flops():
    """Float operations of one compared frame at one output pixel."""
    return 9 * (8 + 5) + 25


def ref_flops(rad, denoise):
    """Float operations of the reference frame at one output pixel."""
    return (2 * rad + 1) ** 2 * (8 + 5 + int(denoise)) + 25


def merge_work(frames, h, w, scale, tile_size, rad_max=1, denoise=False):
    """(bytes, float operations) of merging a Bayer burst of ``frames``
    frames of (h, w) at ``scale``, fractional ones included, into the (3,
    round(scale h), round(scale w)) image."""
    out_px = round(scale * h) * round(scale * w)
    n_cmp = frames - 1
    ny, nx = -(-h // tile_size), -(-w // tile_size)
    cov = 3 * (h // 2) * (w // 2)
    inputs = F32 * (frames * h * w + n_cmp * h * w + n_cmp * ny * nx * 2
                    + frames * cov + (h * w if denoise else 0))
    flops = out_px * (n_cmp * frame_flops() + ref_flops(rad_max if denoise else 1, denoise)) \
        + 3 * out_px
    return inputs + F32 * 3 * out_px, flops
