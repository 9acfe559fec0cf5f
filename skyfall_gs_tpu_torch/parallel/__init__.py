"""Scene-parallel job launching (port of the single-device part of
skyfall_gs_tpu.parallel: ``launcher``).  The JAX package's meshes and
sharded steps are not ported (ROADMAP: left out of the port)."""

from skyfall_gs_tpu_torch.parallel.launcher import SceneJob, make_training_jobs, run_scene_jobs

__all__ = ["SceneJob", "make_training_jobs", "run_scene_jobs"]
