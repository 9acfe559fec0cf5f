"""Millions of (splat, tile) entries per iteration that the views ask the
binning for: the program's counter ``render.entries`` (``ops/binning.py``
``bin_gaussians``, each render's entry total before the capacity cut), from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced iterations."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    n = report()["counters"].get("render.entries")
    if n is None or run.trace is None:
        return None
    return n * 1e-6 / run.trace.units
