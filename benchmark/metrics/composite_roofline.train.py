"""Share of their roofline that the compositing kernels reach: the least
time the traced iterations' compositing needs (``frozen/work.py``
``composite_bounds``: operations over the fp32 peak or bytes over HBM, the
larger, from the reference's own binning of the same splats and cameras)
over the kernels' device time in the trace."""
import re

KERNEL = re.compile(r"(^|[\s:])(fwd|bwd)_kernel\b")


def read(run):
    t, w = run.trace, run.work
    if t is None or not w:
        return None
    s = t.kernel_s(lambda n: KERNEL.search(n) is not None)
    if s <= 0:
        return None
    return 100.0 * (w["bound_s"]["fwd"] + w["bound_s"]["bwd"]) / s
