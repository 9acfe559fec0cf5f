"""Device ms per iteration of the forward and backward compositing kernels."""
import re

KERNEL = re.compile(r"(^|[\s:])(fwd|bwd)_kernel\b")


def read(run):
    t = run.trace
    if t is None or not t.count(lambda n: KERNEL.search(n) is not None):
        return None
    return 1e3 * t.kernel_s(lambda n: KERNEL.search(n) is not None) / t.units
