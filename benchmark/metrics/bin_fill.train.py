"""Share of the keys sorted by the binning that are live entries: the program's
counters ``render.entries`` (entries the views ask for) over
``render.sorted`` (the capacity ``cap`` of every sort, live or not) in
``ops/binning.py`` ``bin_gaussians``, from
``skyfall_gs_tpu_torch.utils.trace.report()`` over the traced iterations."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    c = report()["counters"]
    if not c.get("render.sorted") or "render.entries" not in c:
        return None
    return 100.0 * c["render.entries"] / c["render.sorted"]
