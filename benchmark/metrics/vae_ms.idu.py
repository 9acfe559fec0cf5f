"""Device ms per view of the VAE: the program's spans ``flowedit.encode`` and
``flowedit.decode`` (the VAE calls of ``priors/flowedit.py``
``FlowEditRefiner.run``), from ``skyfall_gs_tpu_torch.utils.trace.report()``
over the traced call's views."""


def read(run):
    try:
        from skyfall_gs_tpu_torch.utils.trace import report
    except ImportError:         # a program without the tracer
        return None
    spans = report()["spans"]
    s = [spans[k]["device_s"] for k in ("flowedit.encode", "flowedit.decode") if k in spans]
    if not s or run.trace is None:
        return None
    return 1e3 * sum(s) / run.trace.units
