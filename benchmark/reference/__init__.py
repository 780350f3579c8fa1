"""The plain reference of the benchmark: the burst pipeline in plain torch,
independent of the program (it imports nothing of ``hmsr_tpu_torch``)."""

from .pipeline import reference_burst

__all__ = ["reference_burst"]
