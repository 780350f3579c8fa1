"""Variants of K7 (``csrc/refill.cu``) timed against the library's K7 on the
inputs that ``chip_smoke.py`` holds it to, in one process.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 -m hmsr_tpu_torch.probe_refill_kernel [--src DIR]
        [--variant NAME=FLAGS ...] [--wrapper] [--out FILE]

Each variant is ``refill.cu`` from ``--src`` (a ``csrc`` directory; default
this package's, an edited copy to try a change) built as
:func:`hmsr_tpu_torch.probe_fused_kernel.build` builds K6's, into
``build/hmsr_kernels/probe_refill/`` (git-ignored with the library), then
loaded with ``ctypes`` and called as :func:`hmsr_tpu_torch.ops.cuda_merge`
calls K7, on: K6's accumulators of the fused main path
(:func:`hmsr_tpu_torch.probe_fused_kernel.inputs`, 19 frames of 3000x4000,
x2, Ts=16) per slab, and their 6000x8000 rows as the scan forms' image
(planes 6016 rows apart);
:func:`hmsr_tpu_torch.synthetic.starved_accumulators` per slab (the
stress input); :func:`hmsr_tpu_torch.synthetic.edge_starved_accumulators`
at 3x6000x8000 as an image. Per variant and input it prints the device time
(:func:`hmsr_tpu_torch.measure.timed`), its ptxas registers and spills,
and max|d| against the library's K7 on the same input; every line carries
the card's name and power limit. With no ``--variant`` it times the source
as it is.

``--wrapper`` builds no variant: it times the library's K7 through
``cuda_merge.refill_groups`` per slab and per tile on K6's accumulators of
those inputs at x2 (B = 32) and x1 (B = 16), max|d| against
``cuda_merge.refill_plain`` beside each. That mode uses only names the
package has had since K7 was added, so this file and
``probe_fused_kernel.py`` copied into an older checkout's package time that
checkout's K7 on the same accumulators.
"""

import ctypes
import os

import torch

from . import probe_fused_kernel as pf
from .measure import card, timed
from .ops import _build, cuda_merge
from .synthetic import CFA_RGGB

OUT_DIR = os.path.join(_build.BUILD_DIR, "probe_refill")


def cases(device, seed=13):
    """``{name: (num, den, out_h, out_w, gh, gw, border)}``: the inputs, each
    with K7's launch arguments as the library's wrappers give them."""
    from .ops.accumfix import REFILL_BORDER
    from .synthetic import edge_starved_accumulators, starved_accumulators
    n6, d6 = cuda_merge.merge_fused_accumulate(*pf.inputs(device), CFA_RGGB, pf.TS, pf.S)
    B, (c, h, w) = pf.TS * pf.S, n6.shape
    oh, ow = pf.H * pf.S, pf.W * pf.S
    gen = torch.Generator(device).manual_seed(seed)
    ns, ds = starved_accumulators(gen, (c, h, w), device)
    ne, de = edge_starved_accumulators(gen, (c, oh, ow), device)
    return {"real slab (K6's accumulators)": (n6, d6, oh, ow, B, w, -1),
            "real image (their rows, strided planes)": (n6[:, :oh], d6[:, :oh], oh, ow,
                                                        oh, ow, REFILL_BORDER),
            "stress slab": (ns, ds, oh, ow, B, w, -1),
            "edge-starved image": (ne, de, oh, ow, oh, ow, REFILL_BORDER)}


def variant_lines(variants, src, device, smi):
    from .ops.accumfix import STARVED_DEN
    from .utils.types import EPSILON_DIV
    inputs_ = cases(device)
    lines = ["K7 refill_kernel: device ms per input, against the library's K7"]
    for name, (so, ptx) in pf.build(variants, src, "refill.cu", "refill_kernel",
                                    OUT_DIR).items():
        fn = ctypes.CDLL(os.path.abspath(so)).hmsr_refill
        fn.argtypes, fn.restype = _build.SIGNATURES["hmsr_refill"], ctypes.c_int
        parts = []
        for what, (num, den, oh, ow, gh, gw, border) in inputs_.items():
            c, h, w = num.shape
            ref = cuda_merge._launch_refill(num, den, oh, ow, gh, gw, border)
            out = torch.empty_like(ref)
            P = _build.ptr

            def call():
                _build.check(fn(P(num), P(den), P(out), c, h, w, num.stride(0), gh, gw,
                                oh, ow, border, STARVED_DEN, EPSILON_DIV,
                                _build.stream_of(num)), "hmsr_refill")
            call()
            torch.cuda.synchronize()
            same = torch.equal(torch.isnan(out), torch.isnan(ref))
            d = float((torch.nan_to_num(out) - torch.nan_to_num(ref)).abs().max())
            parts.append(f"{what} {timed(call).ms:.4f} ms (max|d| {d:.3e}"
                         f"{'' if same else ', NaN where the library has none'})")
        lines.append(f"  {name}: {ptx.get('registers')} registers, spills "
                     f"{ptx.get('spill_stores')}/{ptx.get('spill_loads')} B; "
                     + "; ".join(parts) + f" [{smi}]")
    return lines


def wrapper_lines(device, smi):
    lines = [f"K7 through refill_groups on K6's accumulators ({pf.F} frames of "
             f"{pf.H}x{pf.W}, Ts={pf.TS}): device ms"]
    for s in (2, 1):
        num, den = cuda_merge.merge_fused_accumulate(*pf.inputs(device), CFA_RGGB,
                                                     pf.TS, s)
        for tiles in (False, True):
            args = (num, den, pf.TS * s, pf.H * s, pf.W * s, tiles)
            d = (torch.nan_to_num(cuda_merge.refill_groups(*args))
                 - torch.nan_to_num(cuda_merge.refill_plain(*args))).abs().max()
            tk = timed(lambda: cuda_merge.refill_groups(*args))
            lines.append(f"  x{s} B={pf.TS * s} {'tile' if tiles else 'slab'} "
                         f"{tuple(num.shape)}: {tk.ms:.4f} ms (max|d| against "
                         f"refill_plain {float(d):.3e}) [{smi}]")
        del num, den
    return lines


def main(argv=None):
    ap = pf.parser(__doc__, "64 registers=-maxrregcount=64")
    ap.add_argument("--wrapper", action="store_true",
                    help="time the library's K7 through refill_groups, no variants")
    args = ap.parse_args(argv)
    variants = pf.variants_of(args, "probe_refill_kernel")
    smi = card()
    lines = wrapper_lines("cuda", smi) if args.wrapper else \
        variant_lines(variants, args.src, "cuda", smi)
    pf.report([smi] + lines, args.out)


if __name__ == "__main__":
    main()
