"""The whole training step's share of the fp32 peak: the benchmark's frozen
operation count of the traced iterations (``frozen/work.py`` ``step_flops``)
over the peak times the untraced window's seconds per iteration."""


def read(run):
    w = run.work
    if not w or w["s_per_unit"] <= 0:
        return None
    return 100.0 * w["step_flops"] / (w["peak_flops"] * w["s_per_unit"])
