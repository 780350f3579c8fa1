"""Command line of the port (twin of the JAX package's ``run_handheld.py``):
a burst folder or ``.npz`` bundle becomes a PNG, TIFF or DNG image.

    python -m hmsr_tpu_torch.run_handheld --impath <burst_dir_or_npz> \\
        --outpath out.png [--config my.yaml] [scale=2 ica.tuning.n_iter=4 ...]

The defaults, then the YAML file (needs pyyaml), then the dotted
``key=value`` overrides; a parameter banner; :func:`hmsr_tpu_torch.process`
on the card, or on the CPU when ``HMSR_FORCE_CPU`` is set (without a card and
without it, it raises); then the image, clipped to [0, 1], saved by suffix:
``.dng`` through :func:`hmsr_tpu_torch.io.dng.save_as_dng` with the finishing
off and the first ``*.dng`` of the input folder as the reference, anything
else as 8 bits through :func:`imsave`. With ``robustness.save_mask`` the
accumulated robustness is saved beside it as ``<name>.rob.png``. At
``verbose=2`` the load, the pipeline, the finishing and the save print their
times.
"""

import argparse
import glob
import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from . import process
from .configs import default_config, load_yaml, merge, update
from .utils.timing import getTime


def str2bool(v):
    v = str(v)
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise TypeError()


def parse_value(value):
    """An override's value: a boolean word, else a Python literal evaluated
    without builtins, else the string itself."""
    try:
        return str2bool(value)
    except TypeError:
        pass
    try:
        return eval(value, {"__builtins__": {}})
    except Exception:
        return value


def print_parameters(config):
    print("\nParameters:\n")
    print(f"  Upscaling factor:       {config.scale}\n")
    if config.scale == 1:
        print("    Demosaicking mode")
    else:
        print("    Super-resolution mode.")
        if config.scale > 2:
            print("    WARNING: sensor integration and lens blur bound the recoverable")
            print("             aliasing; factors above x2 rarely add real detail (see paper).")
    print()
    if config.robustness.enabled:
        print("  Robustness:             enabled")
        print("  ------------------------------")
        print(f"  t:                      {config.robustness.tuning.t:.2f}")
        print(f"  s1:                     {config.robustness.tuning.s1:.2f}")
        print(f"  s2:                     {config.robustness.tuning.s2:.2f}")
        print(f"  Mt:                     {config.robustness.tuning.Mt:.2f}")
        ard = config.accumulated_robustness_denoiser
        if ard.median.enabled or ard.gauss.enabled or ard.merge.enabled:
            print("  Robustness denoising:   enabled")
    else:
        print("  Robustness:             disabled")
    print("\n  Alignment:")
    print("  ------------------------------")
    print(f"  ICA Iterations:         {config.ica.tuning.n_iter}")
    print("\n  Fusion:")
    print("  ------------------------------")
    print(f"  Kernel shape:           {config.merging.kernel}")
    print(f"  k_stretch:              {config.merging.tuning.k_stretch:.2f}")
    print(f"  k_shrink:               {config.merging.tuning.k_shrink:.2f}")
    for k in ("k_detail", "k_denoise"):
        v = config.merging.tuning[k]
        print(f"  {k}:               {'SNR based' if isinstance(v, str) else f'{v:.2f}'}")
    if config.noise_model.alpha is not None:
        print(f"  alpha:                  {config.noise_model.alpha:.2e}")
        print(f"  beta:                   {config.noise_model.beta:.2e}")
    print()


def write_png(fname, rgb_8bit):
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG, with the standard
    library only: an IHDR chunk, one zlib-compressed IDAT of the rows each
    behind filter byte 0, and IEND."""
    if rgb_8bit.dtype != np.uint8 or rgb_8bit.ndim != 3 or rgb_8bit.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{rgb_8bit.shape} {rgb_8bit.dtype}")
    h, w, _ = rgb_8bit.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = rgb_8bit.reshape(h, 3 * w)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(fname, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows)))
        f.write(chunk(b"IEND", b""))


def imsave(fname, rgb_8bit):
    """Save an 8-bit RGB image with the first backend that imports: cv2,
    imageio, PIL, then, for a ``.png``, :func:`write_png` (the standard
    library)."""
    try:
        import cv2
        cv2.imwrite(str(fname), cv2.cvtColor(rgb_8bit, cv2.COLOR_RGB2BGR))
        return
    except ImportError:
        pass
    try:
        import imageio.v3 as iio
        iio.imwrite(str(fname), rgb_8bit)
        return
    except ImportError:
        pass
    try:
        from PIL import Image
        Image.fromarray(rgb_8bit).save(str(fname))
        return
    except ImportError:
        pass
    if Path(fname).suffix.lower() != ".png":
        raise ImportError(f"Saving {fname} requires one of cv2, imageio or PIL; "
                          f"none found (PNG output needs none).")
    write_png(fname, rgb_8bit)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, help="Path to custom config YAML")
    parser.add_argument("--impath", type=str, required=True, help="Input burst path")
    parser.add_argument("--outpath", type=str, required=True, help="Output image path")
    parser.add_argument("overrides", nargs="*",
                        help="Overrides in key=value form, e.g. ica.tuning.n_iter=4")
    args = parser.parse_args()
    device = "cpu" if os.environ.get("HMSR_FORCE_CPU") else "cuda"

    config = default_config()
    if args.config:
        config = merge(config, load_yaml(args.config))
    for item in args.overrides:
        key, value = item.split("=", 1)
        update(config, key, parse_value(value))

    # before the banner, which prints beta beside a given alpha
    if config.noise_model.alpha or config.noise_model.beta:
        if not (config.noise_model.alpha and config.noise_model.beta):
            raise ValueError("Both alpha and beta should be provided")

    print_parameters(config)

    outpath = Path(args.outpath)
    if outpath.suffix == ".dng":
        config.postprocessing.enabled = False

    print(f"Processing with handheld super-resolution ({device})")
    output, debug = process(args.impath, config, device)
    t0 = time.perf_counter()
    output = np.clip(np.nan_to_num(output.cpu().numpy()), 0, 1)
    if output.ndim == 3 and output.shape[-1] == 1:
        output = np.repeat(output, 3, axis=-1)

    if outpath.suffix == ".dng":
        from .io.dng import save_as_dng
        refs = glob.glob(os.path.join(args.impath, "*.dng"))
        if not refs:
            raise ValueError(f"DNG output needs a reference .dng in {args.impath}")
        save_as_dng(output, refs[0], outpath)
    else:
        imsave(outpath, (output * 255 + 0.5).astype(np.uint8))

    rob = debug.get("accumulated_robustness", None)
    if config.robustness.get("save_mask", False) and rob is not None:
        rob = rob.cpu().numpy()
        n = rob.max() if rob.max() > 0 else 1
        rob = np.repeat((rob / n)[..., None], 3, axis=-1)
        rob = np.repeat(np.repeat(rob, max(1, output.shape[0] // rob.shape[0]), 0),
                        max(1, output.shape[1] // rob.shape[1]), 1)
        rob = rob[:output.shape[0], :output.shape[1]]
        imsave(outpath.with_suffix(".rob.png"), (rob * 255 + 0.5).astype(np.uint8))
    getTime(t0, " -- Save", config.verbose >= 2)


if __name__ == "__main__":
    main()
