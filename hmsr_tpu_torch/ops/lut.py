"""Noise-curve lookups as a clamped-index gather (twin of
:func:`hmsr_tpu.ops.lut.lut_lookup`; the one-hot matmul form there exists only
for the TPU)."""

import torch


def lut_lookup(tables, x, scale=1000.0):
    """``[t[clip(round(scale*x), 0, len(t)-1)] for t in tables]``.

    ``tables``: a 1-D tensor or a list of equal-length 1-D tensors; ``x``:
    any shape. Rounding is half-to-even, as ``jnp.round``.
    """
    single = not isinstance(tables, (list, tuple))
    if single:
        tables = [tables]
    n_entries = int(tables[0].shape[0])
    idx = torch.clamp(torch.round(scale * x), 0, n_entries - 1).long()
    outs = [t.to(x.dtype)[idx] for t in tables]
    return outs[0] if single else outs
