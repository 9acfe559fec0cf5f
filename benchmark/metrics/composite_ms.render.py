"""Device ms per frame of the forward compositing kernel."""
import re

KERNEL = re.compile(r"(^|[\s:])fwd_kernel\b")


def read(run):
    t = run.trace
    if t is None or not t.count(lambda n: KERNEL.search(n) is not None):
        return None
    return 1e3 * t.kernel_s(lambda n: KERNEL.search(n) is not None) / t.units
