"""Variants of K6 (``csrc/merge_fused.cu``) timed against the library's K6 at
the fused main path's shapes, in one process.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 -m hmsr_tpu_torch.probe_fused_kernel [--src DIR]
        [--variant NAME=FLAGS ...] [--out FILE]

Each variant is ``merge_fused.cu`` from ``--src`` (a ``csrc`` directory;
default this package's) compiled alone with the library's flags
(:data:`hmsr_tpu_torch.ops._build.NVCC_FLAGS`) and the space-separated
``FLAGS`` (``-D`` macros, say) into ``build/hmsr_kernels/probe_fused/``
(git-ignored with the library), all builds started together, then loaded
with ``ctypes`` and called with the arguments of
:func:`hmsr_tpu_torch.ops.cuda_merge.merge_fused_accumulate` on 19
compared frames of 3000x4000 and a reference made on the card from a seed
(x2, Ts=16, Bayer-steerable). Per variant it prints the device time
(:func:`hmsr_tpu_torch.measure.timed`), its ptxas registers and spills,
and max|d| of num and den against the library's K6 on the same inputs;
every line carries the card's name and power limit. With no ``--variant``
it times the source as it is.
"""

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from .measure import card, timed
from .models.kernels import estimate_kernels
from .ops import _build, cuda_merge
from .synthetic import CFA_RGGB, burst_config

H, W, F, TS, S = 3000, 4000, 19, 16, 2
OUT_DIR = os.path.join(_build.BUILD_DIR, "probe_fused")


def inputs(device, seed=12):
    """The main path's K6 inputs: blocky scenes with 2 % noise, their
    covariances, random flows within +-3 px and robustness in [0, 1)."""
    gen = torch.Generator(device).manual_seed(seed)
    base = torch.rand((F + 1, H // 4 + 1, W // 4 + 1), generator=gen, device=device)
    scene = base.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :H, :W]
    scenes = (scene + 0.02 * torch.randn((F + 1, H, W), generator=gen,
                                         device=device)).clamp(0, 1).contiguous()
    config = burst_config((H, W), 40)
    comp = scenes[1:]
    covs = torch.stack([estimate_kernels(c, config) for c in comp]).contiguous()
    flows = torch.as_tensor(np.random.RandomState(seed).uniform(
        -3, 3, (F, -(-H // TS), -(-W // TS), 2)).astype(np.float32), device=device)
    rob = torch.rand((F, H, W), generator=gen, device=device)
    return (comp, flows, covs, rob, scenes[0].contiguous(),
            estimate_kernels(scenes[0], config).contiguous())


def build(variants, src, source="merge_fused.cu", kernel="merge_fused_kernel<2,0>",
          out_dir=OUT_DIR):
    """``{name: (path of the library, ptxas report of kernel)}`` of every
    variant: ``source`` from ``src`` compiled alone with the library's flags
    and the variant's into ``out_dir``, all ``nvcc`` runs started
    together."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, flags) in enumerate(variants.items()):
        so = os.path.join(out_dir, f"variant{i}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags.split(), "-shared", "-o", so,
               os.path.join(src, source)]
        procs[name] = (so, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, cmd, proc) in procs.items():
        stdout, stderr = proc.communicate()
        _build._check_run(cmd, proc.returncode, stdout, stderr)
        out[name] = (so, _build.ptxas_report(stdout + stderr).get(kernel, {}))
    return out


def parser(doc, example):
    """The probes' arguments: ``--src``, ``--variant`` and ``--out``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--src", default=_build.CSRC)
    ap.add_argument("--variant", action="append", default=[],
                    help=f"NAME=FLAGS, e.g. '{example}'")
    ap.add_argument("--out", default=None, help="also write the lines here")
    return ap


def variants_of(args, tool):
    """``{name: flags}`` of ``--variant`` (the source as it is without any);
    raises ``SystemExit`` without a CUDA card."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool} needs a CUDA card")
    return dict(v.split("=", 1) for v in args.variant) or {"as it is": ""}


def report(lines, out):
    """Print ``lines``, and write them to ``out`` too when it is given."""
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


def main(argv=None):
    args = parser(__doc__, "two blocks=-DMIN_BLOCKS=2").parse_args(argv)
    variants = variants_of(args, "probe_fused_kernel")
    smi, dev = card(), "cuda"
    comp, flows, covs, rob, ref, ref_covs = inputs(dev)
    n_ref, d_ref = cuda_merge.merge_fused_accumulate(comp, flows, covs, rob, ref,
                                                     ref_covs, CFA_RGGB, TS, S)
    shape = tuple(n_ref.shape)
    cfa = cuda_merge._launch_args(CFA_RGGB, False, (comp,))
    lines = [smi, f"K6 merge_fused_kernel<2,0>, {F} frames of {H}x{W} x{S}, Ts={TS}"]
    for name, (so, ptx) in build(variants, args.src).items():
        fn = ctypes.CDLL(os.path.abspath(so)).hmsr_merge_fused
        fn.argtypes, fn.restype = _build.SIGNATURES["hmsr_merge_fused"], ctypes.c_int
        num, den = torch.empty(shape, device=dev), torch.empty(shape, device=dev)
        P = _build.ptr

        def call():
            _build.check(fn(P(comp), F, H, W, P(flows), flows.shape[1], flows.shape[2],
                            P(covs), ref_covs.shape[1], ref_covs.shape[2], P(rob), P(ref),
                            P(ref_covs), None, P(num), P(den), shape[1], shape[2], TS, S,
                            cfa, 0, 0, 1, 1.0, 0.0, _build.stream_of(ref)),
                         "hmsr_merge_fused")
        call()
        torch.cuda.synchronize()
        d = (float((num - n_ref).abs().max()), float((den - d_ref).abs().max()))
        tk = timed(call)
        lines.append(f"  {name}: {tk.ms:.4f} ms, {ptx.get('registers')} registers, "
                     f"spills {ptx.get('spill_stores')}/{ptx.get('spill_loads')} B; "
                     f"max|d| against the library's K6 num {d[0]:.3e} den {d[1]:.3e} "
                     f"[{smi}]")
    report(lines, args.out)


if __name__ == "__main__":
    main()
