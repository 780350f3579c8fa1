"""Device kernels per burst in the trace."""


def read(view):
    n = len(view.ops_of_kind("kernel"))
    return n / view.bursts if n else None
