"""View generation's share of the bf16 peak: FLUX's operations (the frozen
``flux_flops`` at 4096 image and 512 text tokens, two evaluations per
FlowEdit step) plus the VAE's and MoGe's matrix products and convolutions,
per view, over the peak times the window's seconds per view."""


def read(run):
    w = run.work
    if not w or w["s_per_unit"] <= 0:
        return None
    return 100.0 * w["step_flops"] / (w["peak_flops"] * w["s_per_unit"])
