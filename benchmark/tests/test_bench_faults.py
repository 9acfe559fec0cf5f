"""Faults planted in the program's timed path underneath a tiny run must
make ``correct`` false: a training step that leaves the state unchanged,
a loss over half of the view's pixels, a frame or a refined view altered
where it is produced, and a FlowEdit loop that leaves the latents as they
came."""

from __future__ import annotations

import numpy as np
import pytest

import tiny


def _no_update(state, grads, opt_cfg, xyz_lr):
    state.step += 1


def _half_rows(photometric_loss):
    def loss(image, gt, lam):
        h = image.shape[1] // 2
        return photometric_loss(image[:, :h], gt[:, :h], lam)
    return loss


def _altered_frame(render):
    def draw(*a, **k):
        out = render(*a, **k)
        out.color[:8, :8] = 1.0 - out.color[:8, :8]
        return out
    return draw


def _altered_views(run):
    def refine(self, images, **k):
        out = [np.array(o, copy=True) for o in run(self, images, **k)]
        for o in out:
            o[:8, :8] = 1.0 - o[:8, :8]
        return out
    return refine


def _frozen_latents(velocity_fn, x_src, *a, **k):
    return x_src.clone()


def test_step_leaves_state_unchanged(monkeypatch):
    import skyfall_gs_tpu_torch.train.step as step
    monkeypatch.setattr(step, "apply_update", _no_update)
    res, _ = tiny.run("s1_train.sat1m")
    assert not res["correct"], res["checks"]


def test_loss_over_half_of_the_view(monkeypatch):
    import skyfall_gs_tpu_torch.train.step as step
    monkeypatch.setattr(step, "photometric_loss", _half_rows(step.photometric_loss))
    res, _ = tiny.run("s1_train.sat1m")
    assert not res["correct"], res["checks"]


def test_viewer_frame_altered(monkeypatch):
    import skyfall_gs_tpu_torch.model.render as render
    monkeypatch.setattr(render, "render", _altered_frame(render.render))
    res, _ = tiny.run("viewer_1080.sat1m")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["altered", "frozen_latents"])
def test_idu_view_faults(monkeypatch, fault):
    import skyfall_gs_tpu_torch.priors.flowedit as flowedit
    if fault == "altered":
        monkeypatch.setattr(flowedit.FlowEditRefiner, "run",
                            _altered_views(flowedit.FlowEditRefiner.run))
    else:
        monkeypatch.setattr(flowedit, "flow_edit_ode_batch", _frozen_latents)
    res, _ = tiny.run("idu_views.flux1024")
    assert not res["correct"], res["checks"]
