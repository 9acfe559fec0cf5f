"""Share of FLUX's attention calls that launched the fused kernel, in %:
100 times the program's counter ``flux.attention.kernel`` over the count of
its span ``flux.attention``, from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced call.  None on
a program without that span."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    rep = report()
    s = rep["spans"].get("flux.attention")
    if s is None or not s["count"]:
        return None
    return 100.0 * rep["counters"].get("flux.attention.kernel", 0) / s["count"]
