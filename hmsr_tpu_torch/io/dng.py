"""DNG and TIFF output (twin of :mod:`hmsr_tpu.io.dng`), on the host.

:func:`save_as_dng` quantises an RGB image in [0, 1] to 16 bits, writes it
as an uncompressed TIFF (:func:`save_as_tiff`, imageio), copies and
rewrites the tags of a reference DNG in two ``exiftool`` passes, and
finalises the file with Adobe's ``dng_validate``. Both tools are external
programs (their paths from ``HMSR_EXIFTOOL`` and ``HMSR_DNG_VALIDATE``), and
the reference's white balance is read with ``rawpy``; a missing tool or
rawpy raises ``RuntimeError`` before any work.
"""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

EXIFTOOL_PATH = os.environ.get("HMSR_EXIFTOOL", "exiftool")
DNG_VALIDATE_PATH = os.environ.get("HMSR_DNG_VALIDATE", "dng_validate")


def _run_tool(argv, what):
    """Run an external tag tool, raising with its stderr on failure."""
    proc = subprocess.run(argv, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{what} exited with status {proc.returncode}:\n{proc.stderr}")
    return proc


def save_as_tiff(int_im, outpath):
    """Write ``int_im`` as an uncompressed classic (not Big) TIFF at
    ``outpath`` with the suffix ``.tif`` (dng_validate refuses compressed
    input); needs imageio. imageio's default TIFF writer is both, with or
    without the tifffile package; the JAX package's ``bigtiff=False``
    argument is refused by the one without it."""
    import imageio.v3 as iio
    iio.imwrite(Path(outpath).with_suffix(".tif").as_posix(), int_im)


def save_as_dng(np_img, ref_dng_path, outpath):
    """Save an (H, W, 3) float image in [0, 1] as a DNG at ``outpath`` with
    the tags of the DNG at ``ref_dng_path``."""
    if np_img.ndim != 3 or np_img.shape[-1] != 3:
        raise ValueError(f"Got {np_img.shape}, expected HxWx3 RGB image.")
    for tool, name in ((EXIFTOOL_PATH, "exiftool"), (DNG_VALIDATE_PATH, "dng_validate")):
        if shutil.which(tool) is None:
            raise RuntimeError(
                f"{name} not found; DNG output requires the external {name} "
                f"binary. PNG/TIFF output works without it.")

    try:
        import rawpy
    except ImportError as e:
        raise RuntimeError("rawpy is required to read the reference DNG's "
                           "white balance for DNG output") from e

    outpath = Path(outpath)
    with rawpy.imread(str(ref_dng_path)) as raw:
        wb = list(raw.camera_whitebalance)
    wb = [x / wb[1] for x in wb]

    new_white_level = 2 ** 16 - 1
    img = np.clip(np.round(np_img * new_white_level), 0, new_white_level
                  ).astype(np.uint16)
    save_as_tiff(img, outpath)

    tmp_path = outpath.parent / "tmp.dng"
    if tmp_path.exists():
        os.remove(tmp_path)

    cmd = [
        EXIFTOOL_PATH, "-n",
        "-IFD0:SubfileType#=0",
        "-IFD0:PhotometricInterpretation#=34892",
        "-BaselineExposure=0",
        "-SamplesPerPixel#=3",
        "-overwrite_original",
        "-tagsfromfile", str(ref_dng_path),
        "-all:all>all:all",
        "-DNGVersion", "-DNGBackwardVersion",
        "-ColorMatrix1", "-ColorMatrix2",
        "-IFD0:CalibrationIlluminant1<SubIFD:CalibrationIlluminant1",
        "-IFD0:CalibrationIlluminant2<SubIFD:CalibrationIlluminant2",
        "-AsShotNeutral=1 1 1",
        "-IFD0:OpcodeList1<SubIFD:OpcodeList1",
        "-IFD0:OpcodeList2<SubIFD:OpcodeList2",
        "-IFD0:OpcodeList3<SubIFD:OpcodeList3",
        "-o", tmp_path.as_posix(),
        outpath.with_suffix(".tif").as_posix(),
    ]
    _run_tool(cmd, "exiftool (tag copy pass)")

    cmd2 = [
        EXIFTOOL_PATH, "-n", "-overwrite_original",
        "-tagsfromfile", str(ref_dng_path),
        f"-IFD0:AnalogBalance={wb[0]} {wb[1]} {wb[2]}",
        f"-AnalogBalance={wb[0]} {wb[1]} {wb[2]}",
        "-AsShotWhiteXY=", "-BlackLevelDeltaH=", "-BlackLevelDeltaV=",
        "-XMP:ColorTemperature=",
        "-IFD0:ColorMatrix1", "-IFD0:ColorMatrix2",
        "-IFD0:CameraCalibration1", "-IFD0:CameraCalibration2",
        "-IFD0:ProfileHueSatMap1", "-IFD0:ProfileHueSatMap2",
        "-IFD0:ProfileLookTable",
        "-IFD0:AsShotNeutral=1 1 1", "-AsShotNeutral=1 1 1",
        f"-IFD0:WhiteLevel={new_white_level} {new_white_level} {new_white_level}",
        "-IFD0:BlackLevel=0 0 0", "-BlackLevel=0 0 0",
        f"-WhiteLevel={new_white_level} {new_white_level} {new_white_level}",
        "-IFD0:BaselineExposure",
        "-IFD0:CalibrationIlluminant1", "-IFD0:CalibrationIlluminant2",
        "-IFD0:ForwardMatrix1", "-IFD0:ForwardMatrix2",
        tmp_path.as_posix(),
    ]
    _run_tool(cmd2, "exiftool (white-balance pass)")

    cmd3 = [DNG_VALIDATE_PATH, "-16", "-dng",
            outpath.with_suffix(".dng").as_posix(), tmp_path.as_posix()]
    with subprocess.Popen(cmd3, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            print(line, end="")
        proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(
                f"dng_validate exited with status {proc.returncode}")
    os.remove(tmp_path)
