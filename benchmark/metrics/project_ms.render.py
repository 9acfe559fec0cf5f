"""Device ms per frame of the program's span ``render.project``
(``ops/projection.py`` ``project_gaussians`` as ``ops/rasterize.py``
``rasterize`` calls it), from ``skyfall_gs_tpu_torch.utils.trace.report()``
over the traced frames."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("render.project")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["device_s"] / run.trace.units
