"""Share of the training renders' projections that launched the fused
projection kernel (``csrc/projection.cu``), in %: 100 times the program's
counter ``render.project.kernel`` over the count of its span
``render.project``, from ``skyfall_gs_tpu_torch.utils.trace.report()`` over
the traced iterations.  None on a program without that counter."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    rep = report()
    s = rep["spans"].get("render.project")
    launched = rep["counters"].get("render.project.kernel")
    if s is None or not s["count"] or launched is None:
        return None
    return 100.0 * launched / s["count"]
