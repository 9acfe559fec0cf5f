"""Host ms per view of the frame and depth writes: the program's span
``idu.write`` (each PNG of ``train/idu.py`` ``_save_frames`` and the
``render_depth.npy`` of ``_write_depths``), from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced call's views."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    s = report()["spans"].get("idu.write")
    if s is None or run.trace is None:
        return None
    return 1e3 * s["host_s"] / run.trace.units
