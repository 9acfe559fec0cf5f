"""Device ms per view of the program's span ``flowedit.step`` (each FlowEdit
ODE step of ``priors/flowedit.py``: its FLUX velocity evaluations), from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced call's views."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("flowedit.step")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["device_s"] / run.trace.units
