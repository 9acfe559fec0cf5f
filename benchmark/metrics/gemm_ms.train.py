"""Device ms per iteration of the GEMM kernels (cuBLAS; by name)."""


def read(run):
    t = run.trace
    if t is None or not t.count(lambda n: "gemm" in n.lower()):
        return None
    return 1e3 * t.kernel_s(lambda n: "gemm" in n.lower()) / t.units
