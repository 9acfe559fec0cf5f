"""Device ms per view of FLUX's attention: the program's span
``flux.attention`` (the attention call of every FLUX block, fused kernel or
plain version), from ``skyfall_gs_tpu_torch.utils.trace.report()`` over the
traced call's views.  None on a program without that span."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("flux.attention")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["device_s"] / run.trace.units
