"""The multi-device path on ``torch.distributed`` (twin of
:mod:`hmsr_tpu.parallel`)."""

from .sharded import Mesh, make_mesh, make_sharded_pipeline, pad_frames, spawn_ranks

__all__ = ["Mesh", "make_mesh", "make_sharded_pipeline", "pad_frames", "spawn_ranks"]
