"""Multi-device training and scene-parallel job launching (port of
skyfall_gs_tpu.parallel): view-parallel meshes on ``torch.distributed``
(``mesh``, ``sharding``) and the per-scene launcher.  The JAX package's
gaussian-sharded axis is not ported (ROADMAP: left out of the port)."""

from skyfall_gs_tpu_torch.parallel.launcher import SceneJob, make_training_jobs, run_scene_jobs
from skyfall_gs_tpu_torch.parallel.mesh import (
    ViewMesh,
    initialize_distributed,
    launch,
    make_mesh,
    multihost_slot_envs,
)
from skyfall_gs_tpu_torch.parallel.sharding import (
    combine_and_update,
    make_parallel_render,
    make_parallel_train_step,
    make_tile_parallel_render,
)

__all__ = ["SceneJob", "make_training_jobs", "run_scene_jobs", "ViewMesh",
           "initialize_distributed", "launch", "make_mesh", "multihost_slot_envs",
           "combine_and_update", "make_parallel_render", "make_parallel_train_step",
           "make_tile_parallel_render"]
