"""The ranks of ``test_torch_sharded.py``: module-level functions that
:func:`hmsr_tpu_torch.parallel.spawn_ranks` runs in new processes (gloo,
on the CPU). They import torch and the port only, so that a rank starts
without JAX."""

import numpy as np
import torch

from hmsr_tpu_torch.graft_entry import small_config
from hmsr_tpu_torch.models import process as P
from hmsr_tpu_torch.parallel import make_mesh, make_sharded_pipeline, pad_frames
from hmsr_tpu_torch.synthetic import affine_curves

CFA = np.array([[0, 1], [1, 2]])
WB = [1.0, 1.0, 1.0]


def pipeline_config(h, w):
    """The dry run's two-level configuration with the debug outputs and the
    accumulated robustness."""
    c = small_config(h=h, w=w)
    c.debug = True
    c.robustness.save_mask = True
    return c


def sharded_meshes(rank, shapes, ref, comps):
    """Every mesh of ``shapes`` on this rank: ``{shape: (image, acc_r,
    flows, rmaps, comm)}``."""
    config = pipeline_config(*ref.shape)
    out = {}
    for n_frames, n_space in shapes:
        mesh = make_mesh(n_frames, n_space)
        pipe = make_sharded_pipeline(config, CFA, WB, mesh, "cpu")
        frames, weights = pad_frames(comps, n_frames)
        out[(n_frames, n_space)] = pipe(ref, frames, weights, *affine_curves()) \
            + (pipe.comm,)
    return out


def affine_mc(rank):
    """A stand-in for the Monte-Carlo curves that differs on every rank:
    the affine curves (float64) on rank 0, scaled by ``1 + rank``
    elsewhere."""
    return lambda alpha, beta, device: tuple(
        c.astype(np.float64) * (1 + rank) for c in affine_curves(alpha, beta))


def process_mesh(rank, ref, comps, config):
    """``process_arrays`` with the config's ``tpu.mesh`` on this rank, its
    noise curves drawn by :func:`affine_mc`: ``(image, debug)``."""
    P.run_fast_MC = affine_mc(rank)
    return P.process_arrays(ref, comps, config, cfa=CFA, device="cpu")


def sharded_images(rank, ref, comps, cfgs):
    """The sharded pipeline on a (1, 1) mesh once per configuration of
    ``cfgs``, with the affine curves: the images."""
    mesh = make_mesh(1, 1)
    frames, weights = pad_frames(comps, 1)
    return [make_sharded_pipeline(config, CFA, WB, mesh, "cpu")(
        ref, frames, weights, *affine_curves())[0] for config in cfgs]
