"""MIPI RAW10 and RAW12 unpacking (twin of ``unpack_raw10`` /
``unpack_raw12`` in :mod:`hmsr_tpu.io.native_loader`): K9 on the card, its
plain version on the CPU (:mod:`hmsr_tpu_torch.ops.cuda_ingest`), on the
packed bytes' device unless told otherwise.

RAW10 packs 4 pixels in 5 bytes: the 8 high bits of each, then a byte of
their 2 low bits (pixel k at bits 2k). RAW12 packs 2 pixels in 3 bytes: the
8 high bits of each, then a byte of their 4 low bits (pixel 0 low nibble).
"""

from .native_loader import unpack_raw10, unpack_raw12

__all__ = ["unpack_raw10", "unpack_raw12"]
