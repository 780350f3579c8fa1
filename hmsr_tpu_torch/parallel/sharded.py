"""Burst processing over several ranks (twin of
:mod:`hmsr_tpu.parallel.sharded`): data parallel over the frames, spatially
parallel over the HR accumulator's rows.

The JAX package runs one program over a ``('frames', 'space')`` device mesh
(``shard_map``). The port runs one process per rank on
``torch.distributed``: every rank calls the pipeline with the same
arguments, as ``shard_map`` calls its body, and rank ``f * n_space + sp``
takes

- the ``f``-th contiguous block of the (padded) frames: it aligns, weighs
  and merges them into partial accumulators, which are summed over the
  frames group (``all_reduce``; one per burst);
- HR band ``sp`` of the accumulators. The merge is the route's
  (:func:`~hmsr_tpu_torch.models.pipeline.route_of`, as the JAX package
  routes it, ``hmsr_tpu/parallel/sharded.py:82-88``): K5's banded branch
  where the merge is tiled, into
  ``nb`` whole tile rows of ``B = Ts*s`` HR rows from global row ``sp * nb
  * B``, ``nb = ceil(ceil(out_h / B) / n_space)`` (the Pallas path's band
  geometry); the gather merge otherwise, into ``out_h / n_space`` rows
  (``out_h`` must divide).

The reference init runs on every rank. After the reference merge into its
band, the bands are assembled over the space group, one ``broadcast`` per
band and accumulator plane from its owner (both gloo and NCCL take it on
CUDA tensors), and the whole accumulators are normalized with the
border-strip refill, one launch of K7 on the assembled planes as they lie
(no copy): every rank returns the same image.

One process per rank splits the host's work (the port is host-bound: it
launches thousands of small kernels per burst) as it splits the device's. The backend
is whatever the caller initialized; the port picks none. Without a process
group of the mesh's size, :func:`make_mesh` raises: there is no fallback
to one device.
"""

import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.pipeline import (_as_tensor, accum_shape, frame_step, init_reference,
                               merge_reference, normalize_image, route_of, select_merge)
from ..utils.timing import span
from ..utils.types import DEFAULT_FLOAT, resolve_device


class Mesh(NamedTuple):
    """A rank's place in a ``(n_frames, n_space)`` mesh: its coordinates,
    the process groups of its frames axis (the ranks that share its band)
    and space axis (the ranks that share its frames), their global ranks,
    and its CUDA device (None on a host without one)."""
    n_frames: int
    n_space: int
    frame: int
    space: int
    frames_group: object
    space_group: object
    frames_ranks: tuple
    space_ranks: tuple
    device: Optional[torch.device]


def make_mesh(n_frames, n_space):
    """The calling rank's :class:`Mesh` over the initialized default process
    group, which must hold exactly ``n_frames * n_space`` ranks; rank ``r``
    sits at ``(r // n_space, r % n_space)``. Every rank of the group calls
    it (it creates the axes' groups). The rank's device is
    ``cuda:{LOCAL_RANK % device_count}``, made current, where CUDA exists.
    Raises ``RuntimeError`` without such a group."""
    n_frames, n_space = int(n_frames), int(n_space)
    n = n_frames * n_space
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() \
        else None
    if n < 1 or have != n:
        raise RuntimeError(
            f"a ({n_frames}, {n_space}) mesh runs one process per rank on an "
            f"initialized torch.distributed default process group of {n} ranks "
            f"({'none is initialized' if have is None else f'it has {have}'}); "
            f"start the ranks with torchrun --nproc-per-node={n} (or "
            f"hmsr_tpu_torch.parallel.spawn_ranks)")
    rank = dist.get_rank()
    frame, space = divmod(rank, n_space)
    groups = {}
    for f in range(n_frames):                   # the space groups, then the frames'
        ranks = tuple(f * n_space + sp for sp in range(n_space))
        groups[("space", f)] = (ranks, dist.new_group(list(ranks)))
    for sp in range(n_space):
        ranks = tuple(f * n_space + sp for f in range(n_frames))
        groups[("frames", sp)] = (ranks, dist.new_group(list(ranks)))
    device = None
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    (space_ranks, space_group), (frames_ranks, frames_group) = \
        groups[("space", frame)], groups[("frames", space)]
    return Mesh(n_frames, n_space, frame, space, frames_group, space_group,
                frames_ranks, space_ranks, device)


def pad_frames(comp_imgs, n_shards):
    """Pad the frame stack with zero frames to a multiple of ``n_shards``;
    returns ``(frames, weights)``, tensors on the stack's device, weight 1
    for a frame of the burst and 0 for a padding frame (whose robustness,
    and so every contribution, is then 0)."""
    comp_imgs = torch.as_tensor(comp_imgs)
    n = comp_imgs.shape[0]
    pad = (-n) % int(n_shards)
    weights = torch.ones((n + pad,), dtype=DEFAULT_FLOAT, device=comp_imgs.device)
    if pad:
        comp_imgs = torch.cat([comp_imgs, comp_imgs.new_zeros((pad, *comp_imgs.shape[1:]))])
        weights[n:] = 0.0
    return comp_imgs, weights


def band_geometry(config, raw_shape, n_space):
    """``rows``: the HR rows of each of the ``n_space`` bands (band ``sp``
    starts at global row ``sp * rows``): whole tile rows where the route's
    merge is tiled (K5), ``out_h / n_space`` for the gather merge
    (``ValueError`` unless it divides, the JAX package's rule)."""
    _, out_h, _ = accum_shape(config, raw_shape)
    if route_of(config).tiled:
        B = int(config.block_matching.tuning.tile_size) * int(config.scale)
        return -(-(-(-out_h // B)) // n_space) * B
    if out_h % n_space:
        raise ValueError(f"the gather merge shards {out_h} HR rows over {n_space} "
                         f"bands only if they divide")
    return out_h // n_space


def _gather_blocks(block, out, index, ranks, group):
    """Writes the blocks of a group's ranks into ``out`` along its first
    axis, in group order: one ``broadcast`` of each block from its owner
    (``index`` is this rank's place in ``ranks``). Returns the number of
    broadcasts and their bytes."""
    k, n = block.shape[0], len(ranks)
    for i, src in enumerate(ranks):
        part = out[i * k:(i + 1) * k]
        if i == index:
            part.copy_(block)
        if n > 1:
            dist.broadcast(part, src=src, group=group)
    return (n, out.numel() * out.element_size()) if n > 1 else (0, 0)


def make_sharded_pipeline(config, cfa_pattern, white_balance, mesh, device=None):
    """The sharded pipeline on ``mesh`` (:func:`make_mesh`): ``fn(ref,
    comps, weights, std, diff) -> (image, acc_r[, flows, rmaps])``.

    Every rank calls ``fn`` with the same arguments: ``comps``/``weights``
    padded to a multiple of the frames axis (:func:`pad_frames`). ``image``
    is the whole ``(round(s H), round(s W), c)`` image; ``acc_r`` the
    accumulated robustness (H, W), or None unless the denoiser or
    ``robustness.save_mask`` asks for it; with ``config.debug``, ``flows``
    and ``rmaps`` over the padded frame count. Every rank returns the same.
    ``device``: the rank's (``mesh.device`` by default; the CPU when the
    caller asks for it). ``fn.comm`` counts the collectives of the last call
    and their bytes.
    """
    device = resolve_device(device if device is not None else (mesh.device or "cuda"))
    cfa = np.asarray(cfa_pattern)
    wb = [float(x) for x in white_balance]
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    accumulate_r = denoise or bool(config.robustness.save_mask)
    debug_mode = bool(config.debug)
    merge_frame = select_merge(config)

    def fn(ref_img, comps, weights, std_curve, diff_curve):
        ref_img = _as_tensor(ref_img, device)
        comps = _as_tensor(comps, device)
        weights = _as_tensor(weights, device)
        curves = (_as_tensor(std_curve, device), _as_tensor(diff_curve, device))
        if comps.shape[0] % mesh.n_frames or weights.shape[0] != comps.shape[0]:
            raise ValueError(f"{comps.shape[0]} frames and {weights.shape[0]} weights "
                             f"for {mesh.n_frames} frame shards: pad them (pad_frames)")
        per = comps.shape[0] // mesh.n_frames
        local = slice(mesh.frame * per, (mesh.frame + 1) * per)
        n_ch, out_h, out_w = accum_shape(config, ref_img.shape)
        rows = band_geometry(config, ref_img.shape, mesh.n_space)
        row_offset = mesh.space * rows
        comm = {"all_reduce": 0, "broadcast": 0, "bytes": 0}

        def count(n_broadcasts, nbytes):
            comm["broadcast"] += n_broadcasts
            comm["bytes"] += nbytes

        align_state, ref_stats = init_reference(ref_img, curves, config, cfa, wb)
        # num and den in one buffer: one all_reduce for both
        acc = torch.zeros((2 * n_ch, rows, out_w), dtype=DEFAULT_FLOAT, device=device)
        num, den = acc[:n_ch], acc[n_ch:]
        acc_r = torch.zeros(ref_img.shape, dtype=DEFAULT_FLOAT, device=device) \
            if accumulate_r else None
        flows, rmaps = [], []
        for frame, weight in zip(comps[local], weights[local]):
            flow, r, covs = frame_step(frame, align_state, ref_stats, config, cfa, wb,
                                       weight)
            if acc_r is not None:
                acc_r = acc_r + r
            with span("merge"):
                merge_frame(frame, flow, covs, r, num, den, cfa, config,
                            row_offset=row_offset)
            if debug_mode:
                flows.append(flow.to(DEFAULT_FLOAT))
                rmaps.append(r)

        if mesh.n_frames > 1:                   # partial sums over the frame shards
            for t in (acc,) + ((acc_r,) if acc_r is not None else ()):
                dist.all_reduce(t, group=mesh.frames_group)
                comm["all_reduce"] += 1
                comm["bytes"] += t.numel() * t.element_size()
        merge_reference(ref_img, num, den, cfa, config, acc_r, row_offset)

        # the bands, assembled plane by plane over the space group
        full = torch.empty((2 * n_ch, mesh.n_space * rows, out_w), dtype=DEFAULT_FLOAT,
                           device=device)
        for p in range(2 * n_ch):
            count(*_gather_blocks(acc[p], full[p], mesh.space, mesh.space_ranks,
                                  mesh.space_group))
        del acc, num, den
        full = full[:, :out_h]
        image = normalize_image(full[:n_ch], full[n_ch:])
        outs = (image, acc_r)
        if debug_mode:
            for stack in (torch.stack(flows), torch.stack(rmaps)):
                out = stack.new_empty((comps.shape[0], *stack.shape[1:]))
                count(*_gather_blocks(stack, out, mesh.frame, mesh.frames_ranks,
                                      mesh.frames_group))
                outs += (out,)
        fn.comm = comm
        return outs

    fn.comm = None
    return fn


def spawn_ranks(fn, world_size, args=(), backend="gloo", tmp_dir=None, threads=None):
    """Run ``fn(rank, *args)`` in ``world_size`` new processes, each a rank
    of a default process group of ``backend`` (``init_method`` a file in a
    new temporary directory under ``tmp_dir``: no TCP port to choose), and
    return the ranks' results in rank order. ``fn`` is a module-level
    function; ``args`` and the results pass through pickling, so keep their
    tensors on the CPU. ``threads``: each rank's CPU threads. A rank that
    raises makes this raise (and the other ranks are ended)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(fn, world_size, backend, init, tmp, threads, args),
                 nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def _rank_main(rank, fn, world_size, backend, init, tmp, threads, args):
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init, world_size=world_size, rank=rank)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
