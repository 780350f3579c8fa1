"""Verbose-gated stage timing (twin of :mod:`hmsr_tpu.utils.timing`).

The reference's ``timer``/``getTime`` print tracing: a timed section ends in
``torch.cuda.synchronize()`` when its inputs or outputs lie on the card, so
the printed time is the device's, not the enqueue's.
"""

import time

import torch


def _sync(*trees):
    """Synchronise the card if any tensor in ``trees`` (nested tuples, lists
    and dict values) lies on it."""
    stack = list(trees)
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())


def getTime(current_time, label, print_time=True, space_size=50):
    """Print the elapsed time since ``current_time``; return a new timestamp."""
    if print_time:
        print(label, " " * (space_size - len(label)), ": ",
              round((time.perf_counter() - current_time) * 1000, 2), "milliseconds")
    return time.perf_counter()


def timer(func, enabled, start_s=None, end_s=None, space_size=50):
    """Wrap ``func`` with device-synchronised wall-clock printing; when
    ``enabled`` is falsy the function is returned untouched."""
    if not enabled:
        return func

    def wrapper(*args, **kwargs):
        _sync(args, kwargs)
        t1 = time.perf_counter()
        if start_s is not None:
            print(start_s)
        out = func(*args, **kwargs)
        _sync(out)
        if end_s is not None:
            print(end_s, " " * (space_size - len(end_s)), ": ",
                  round((time.perf_counter() - t1) * 1000, 2), "milliseconds")
        return out

    return wrapper
