"""Host-clock ms per view of FlowEdit (the refiner's run: VAE encode, FLUX velocities, VAE decode),
from the benchmark's spans around that call over the window's calls."""


def read(run):
    s = run.spans.get("flowedit")
    n = run.work.get("window_views") if run.work else None
    if not s or not n:
        return None
    return 1e3 * sum(s) / n
