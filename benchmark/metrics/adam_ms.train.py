"""Device ms per iteration of the program's span ``train.adam``
(``train/step.py`` ``apply_update``: Adam and the weight decay), from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced iterations."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("train.adam")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["device_s"] / run.trace.units
