"""Carry per-burst state of the JAX package over to the port.

``from_numpy(tree, device)`` takes a tree of the JAX package's state whose
arrays were converted with ``np.asarray`` (``jax.tree_util.tree_map``) and
returns the port's equivalents on ``device``:

- arrays (noise curves, flows, covariances, accumulators) -> tensors;
- ``AlignmentRefState`` (with its ``IcaRefState`` list), ``IcaRefState`` and
  ``RefStats`` -> the port's NamedTuples of the same name. Fields the port
  does not have (``AlignmentRefState.ica_pallas``) are dropped. The port's
  ``IcaRefState.terms``, which the JAX tuple does not have, is derived from
  the carried Hessian with ``solve_terms``, as ``init_ica`` computes it.

Named tuples are matched by class name, so this module imports nothing of
the JAX package.
"""

import numpy as np
import torch

from .models.alignment import AlignmentRefState
from .models.ica import IcaRefState
from .models.robustness import RefStats
from .ops.cuda_ica import solve_terms

_TYPES = {t.__name__: t for t in (AlignmentRefState, IcaRefState, RefStats)}


def from_numpy(tree, device):
    device = torch.device(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(tree), device=device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        if name not in _TYPES:
            raise TypeError(f"no port type for {name}")
        port = _TYPES[name]
        fields = {f: from_numpy(getattr(tree, f), device)
                  for f in port._fields if f in tree._fields}
        if port is IcaRefState and "terms" not in fields:
            fields["terms"] = solve_terms(fields["hessian"])
        return port(**fields)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    raise TypeError(f"cannot convert {type(tree).__name__}")
