"""What the benchmark may not load: JAX, its relatives, and the JAX package
``hmsr_tpu`` that the port was made from. Names are compared by their
top-level part, whole: ``hmsr_tpu_torch`` is the port, not ``hmsr_tpu``."""

BANNED = frozenset({"jax", "jaxlib", "flax", "hmsr_tpu"})


def banned_loaded(modules):
    """The sorted top-level names in ``modules`` (an iterable of module
    names, such as ``sys.modules``) that are banned."""
    return sorted({name.split(".")[0] for name in modules} & BANNED)
