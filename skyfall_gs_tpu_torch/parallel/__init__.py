"""Multi-device training and scene-parallel job launching (port of
skyfall_gs_tpu.parallel): view-parallel meshes on ``torch.distributed``
(``mesh``, ``sharding``), gaussian-sharded training (``gauss_shard``) and
the per-scene launcher."""

from skyfall_gs_tpu_torch.parallel.gauss_shard import (
    gather_train_state,
    make_gauss_sharded_train_step,
    make_grid_train_step,
    make_sharded_densify,
    shard_train_state,
    sharded_grow_capacity,
    sharded_render,
    sharded_render_merge,
)
from skyfall_gs_tpu_torch.parallel.launcher import SceneJob, make_training_jobs, run_scene_jobs
from skyfall_gs_tpu_torch.parallel.mesh import (
    ViewMesh,
    all_gather_replicated,
    all_gather_sum_grad,
    grid_meshes,
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
           "all_gather_replicated", "all_gather_sum_grad", "grid_meshes",
           "initialize_distributed", "launch", "make_mesh", "multihost_slot_envs",
           "combine_and_update", "make_parallel_render", "make_parallel_train_step",
           "make_tile_parallel_render", "gather_train_state", "make_gauss_sharded_train_step",
           "make_grid_train_step", "make_sharded_densify", "shard_train_state",
           "sharded_grow_capacity", "sharded_render", "sharded_render_merge"]
