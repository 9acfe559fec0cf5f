"""Kernels launched per training iteration, from the traced window (device
operations other than copies and fills)."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops:
        return None
    return t.count(lambda n: not n.startswith(("Memcpy", "Memset"))) / t.units
