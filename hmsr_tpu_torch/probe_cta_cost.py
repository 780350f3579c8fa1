"""P1 and P2 on the card: the per-block fixed cost, and the row-block sum of
a pyramid level.

Run from the root of a checkout, on a host with one CUDA card and ``nvcc``::

    python3 -m hmsr_tpu_torch.probe_cta_cost [--blocks 16384 32768 65536]

P1 (``csrc/probes.cu``, the counterpart of the TPU probe
``tools/probe_program_cost.py``) launches grids of 16k-64k blocks of 128
threads whose body is empty, stages 1024 floats in shared memory, or runs
a chain of 100 dependent multiply-adds per thread; each is checked against
its plain version and timed (device time and host time per call,
:func:`hmsr_tpu_torch.measure.timed`) beside the one PyTorch call that
writes the same, where there is one (``torch.arange`` for the empty body,
a strided copy for the staging body), and the per-block cost is the slope
of time over blocks between the smallest and the largest grid. P2 (the
counterpart of ``tools/probe_l2ica3.py:trivial_pallas_sum``) sums the
8-row blocks of the bright burst's grey image and of its pyramid
level 2 (after the blur), against its plain version. Every line carries
the card's name and power limit.
"""

import argparse

import torch

from .configs import default_config
from .measure import bound, card, timed
from .ops import cuda_probes
from .ops.grey import compute_grey_image
from .ops.pyramid import build_gaussian_pyramid
from .synthetic import make_burst

BLOCKS = (16384, 32768, 65536)
N_STAGE, N_CHAIN = 1024, 100
#: one PyTorch call that computes what a P1 body writes, where there is one
LIBRARY = {
    "empty": lambda x, n, nb: torch.arange(nb, device=x.device, dtype=torch.float32),
    "stage": lambda x, n, nb: x.view(nb, n)[:, n - 1].clone(),
    "chain": None}


def run_p1(device, blocks=BLOCKS, log=print, tag=""):
    """P1 for each body and grid: max|d| against the plain version, kernel
    and plain ms, bound; returns ``{body: [row per grid]}`` and, per body,
    the per-block ns (slope between the first and the last grid)."""
    res, per_block_ns = {}, {}
    for kind, n in (("empty", 0), ("stage", N_STAGE), ("chain", N_CHAIN)):
        rows = []
        for nb in blocks:
            x = cuda_probes.probe_input(kind, nb, n, device)
            got = cuda_probes.cta_probe(kind, x, n, nb)
            want = cuda_probes.cta_probe_plain(kind, x, n, nb)
            err = float((got - want).abs().max())
            ms, host_us = timed(lambda: cuda_probes.cta_probe(kind, x, n, nb))
            ms_p = timed(lambda: cuda_probes.cta_probe_plain(kind, x, n, nb), n=3,
                         hold=False).ms
            lib = LIBRARY[kind]
            ms_l = timed(lambda: lib(x, n, nb)).ms if lib else None
            bnd = bound(4 * (x.numel() if kind != "empty" else 0) + 4 * got.numel(),
                        2 * n * got.numel() if kind == "chain" else 0)
            rows.append(dict(blocks=nb, err=err, ms=ms, host_us=host_us, plain_ms=ms_p,
                             library_ms=ms_l, bound_ms=bnd[0], bound_by=bnd[1]))
            lib_text = f"one torch call {ms_l:.4f} ms" if lib else "no one torch call"
            log(f"  P1 {kind} body{f' n={n}' if n else ''}, {nb} blocks of "
                f"{cuda_probes.PROBE_THREADS} threads: max|d| {err:.3e}, kernel "
                f"{ms:.4f} ms ({1e6 * ms / nb:.2f} ns/block; host {host_us:.1f} us per "
                f"call), plain {ms_p:.4f} ms, {lib_text}, bound {bnd[0]:.4f} ms "
                f"({bnd[1]}) [{tag}]")
            if err != 0.0:
                raise AssertionError(f"P1 {kind} at {nb} blocks: max|d| {err:.3e}")
        per_block_ns[kind] = 1e6 * (rows[-1]["ms"] - rows[0]["ms"]) / \
            (rows[-1]["blocks"] - rows[0]["blocks"]) if len(rows) > 1 else float("nan")
        log(f"  P1 {kind} body: {per_block_ns[kind]:.3f} ns per added block "
            f"(slope {blocks[0]} -> {blocks[-1]} blocks) [{tag}]")
        res[kind] = rows
    return res, per_block_ns


def run_p2(device, log=print, tag=""):
    """P2 on the grey image of a 3000x4000 bright frame and on its pyramid
    level 2; 1e-5 relative against the plain version (float sums in another
    order); the library yardstick is ``torch.segment_reduce``. Returns a row
    per input."""
    frame = make_burst(3000, 4000, 1, 0, device)[0]
    grey = compute_grey_image(frame, "FFT")
    factors = default_config().block_matching.tuning.factors
    level = build_gaussian_pyramid(grey, factors)[2].contiguous()
    rows = []
    for name, x in (("grey", grey.contiguous()), ("pyramid level 2", level)):
        got = cuda_probes.row_block_sum(x)
        want = cuda_probes.row_block_sum_plain(x)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        ms, host_us = timed(lambda: cuda_probes.row_block_sum(x))
        ms_p = timed(lambda: cuda_probes.row_block_sum_plain(x)).ms
        # one library call of the same function: a segment sum over 8 rows
        h, w = x.shape
        lengths = torch.full((-(-h // 8),), 8 * w, device=device, dtype=torch.int64)
        lengths[-1] = (h - 8 * (len(lengths) - 1)) * w
        flat = x.view(-1)
        # (it waits for the card on the host, so no call can queue behind a hold)
        ms_l = timed(lambda: torch.segment_reduce(flat, "sum", lengths=lengths),
                     hold=False).ms
        bnd = bound(4 * (x.numel() + got.numel()), x.numel())
        rows.append(dict(input=name, err=float((got - want).abs().max()), rel=rel,
                         ms=ms, host_us=host_us, plain_ms=ms_p, library_ms=ms_l,
                         bound_ms=bnd[0], bound_by=bnd[1]))
        log(f"  P2 row-block sum of the {name} {tuple(x.shape)}: rel max|d| {rel:.3e}, "
            f"kernel {ms:.4f} ms (host {host_us:.1f} us per call), plain {ms_p:.4f} ms, "
            f"torch.segment_reduce {ms_l:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) "
            f"[{tag}]")
        if not rel <= 1e-5:
            raise AssertionError(f"P2 on the {name}: relative error {rel:.3e}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=list(BLOCKS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_cta_cost needs a CUDA card")
    tag = card()
    print(tag, flush=True)
    run_p1("cuda", tuple(args.blocks), tag=tag)
    run_p2("cuda", tag=tag)


if __name__ == "__main__":
    main()
