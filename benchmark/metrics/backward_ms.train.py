"""Device ms per iteration of the program's span ``train.backward``
(``torch.autograd.grad`` in ``train/step.py`` ``grads_fn``), from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced iterations."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("train.backward")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["device_s"] / run.trace.units
