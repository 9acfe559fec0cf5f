"""Host-clock ms per view of the orbit renders and their PNG writes (IDUOrchestrator._render),
from the benchmark's spans around that call over the window's calls."""


def read(run):
    s = run.spans.get("render_write")
    n = run.work.get("window_views") if run.work else None
    if not s or not n:
        return None
    return 1e3 * sum(s) / n
