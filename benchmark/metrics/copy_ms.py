"""Device ms per burst of copies between host and device memory (the
profiler's memcpy rows, host to device and device to host)."""


def read(view):
    if not view.ops:
        return None
    ops = [o for o in view.ops_of_kind("memcpy") if "HtoD" in o.name or "DtoH" in o.name]
    return sum(o.end_ns - o.start_ns for o in ops) / 1e6 / view.bursts
