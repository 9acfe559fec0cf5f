"""Port parity: the Trainer and IDU episodes on a view mesh
(``Trainer(mesh=...)``), and ``cli.train --data_parallel``, on gloo ranks
spawned on the CPU.

The ranks run tests/torch_ranks.py's ``trainer_runs`` (no JAX in a rank)
while the JAX Trainer runs here on 2 of the 8 virtual CPU devices.

Tolerances, and why:
  * against JAX's 2-device view-mesh Trainer (``fuse_steps=1``; 12
    iterations on tests/test_train.py's synthetic scene, no densify, no ray
    jitter): the B-view picks and the host stream's final state EXACTLY;
    ``xyz`` within 1e-3 of its range and Adam's opacity moment 1e-3
    norm-relative, as tests/test_torch_trainer.py holds the single-device
    trajectory (an element whose gradient sits near zero may step by
    lr * sign(g) either way);
  * every rank's state bit-equal after training (SHA-256 of parameters,
    Adam moments and densification state);
  * a 1-rank mesh bit-equal to the single-device Trainer, densify and ray
    jitter on (the mean over one rank is the identity; rank 0's jitter
    generator is seeded as the single-device Trainer's).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from skyfall_gs_tpu.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu.parallel.mesh import make_mesh as jmake_mesh
from skyfall_gs_tpu.train.loop import Trainer as JTrainer
from skyfall_gs_tpu_torch.cli import train as train_cli
from skyfall_gs_tpu_torch.config import ModelConfig as TModelConfig
from skyfall_gs_tpu_torch.config import OptimizationConfig as TOptimizationConfig
from skyfall_gs_tpu_torch.config import PipelineConfig as TPipelineConfig
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.parallel.sharding import state_digest
from skyfall_gs_tpu_torch.train.checkpoint import peek_checkpoint_meta
from skyfall_gs_tpu_torch.train.loop import Trainer as TTrainer
from tests import torch_ranks
from tests.test_cli_pipeline import _write_scene
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_parallel import JOIN_S, camera_arrays, in_background, rel
from tests.test_train import _synthetic_scene

torch.set_num_threads(1)
ITERS = 12
OPT = dict(iterations=18, densify_from_iter=10 ** 9, densify_until_iter=0,
           opacity_reset_interval=10 ** 9, lambda_depth=0.0, lambda_opacity=0.01,
           position_lr_max_steps=18)
DENSIFY = dict(iterations=16, lambda_depth=0.1, densify_from_iter=2, densify_until_iter=14,
               densification_interval=8, lambda_pseudo_depth=0.05, sample_pseudo_interval=5,
               start_sample_pseudo=1, end_sample_pseudo=100)
IDU = dict(iterations=14, idu_episode_iterations=14, idu_densify_until_iter=10,
           densify_from_iter=2, densification_interval=7,
           idu_opacity_reset_interval=10 ** 9, idu_testing_interval=10 ** 9,
           idu_num_cams=2, idu_num_samples_per_view=1, idu_render_size=32,
           idu_train_ratio=0.5, lambda_depth=0.5, idu_refine=False,
           lambda_pseudo_depth=0.1, sample_pseudo_interval=5,
           idu_position_lr_max_steps=14, densify_grad_threshold=1e-7)
PAUSE_S = 2.5


def scene_arrays(scene) -> dict:
    def views(vs):
        return [dict(camera=camera_arrays(v.camera), image=v.image, mask=v.mask,
                     depth=v.depth, name=v.image_name) for v in vs]

    return dict(source_path=scene.source_path, scene_type=scene.scene_type,
                points=scene.points, colors=scene.colors, train=views(scene.train_views),
                test=views(scene.test_views), extent=scene.cameras_extent)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    scene = _synthetic_scene(np.random.default_rng(0))
    jtr = JTrainer(ModelConfig(model_path=str(root / "jax")), OptimizationConfig(**OPT),
                   PipelineConfig(fuse_steps=1), scene, mesh=jmake_mesh(2))
    js = jtr.init_state()
    payload = dict(scene=scene_arrays(scene), root=str(root), opt=OPT, iters=ITERS,
                   init=jax_state_to_numpy(js.model), densify_opt=DENSIFY,
                   densify_iters=DENSIFY["iterations"], idu_opt=IDU, pause_s=PAUSE_S)
    join = in_background(tmesh.launch, torch_ranks.trainer_runs, 2, (payload,),
                         device="cpu", join_timeout_s=JOIN_S)
    jpicks = []
    pick = jtr._pick_step

    def recorded():
        g, i = pick()
        jpicks.append([g.names[j] for j in i])
        return g, i

    jtr._pick_step = recorded
    js = jtr.train(js, iterations=ITERS)
    return root, js, jpicks, jtr.py_rng.getstate(), join()


def test_trainer_on_a_mesh_matches_jax(runs):
    _, js, jpicks, jstream, ranks = runs
    got = ranks[0]["vs_jax"]
    assert got["picks"] == jpicks and len(jpicks) == ITERS
    assert any(a != b for a, b in jpicks), "every step drew one view twice"
    assert got["py_rng"] == jstream
    st = got["state"]
    assert st["step"] == st["count"] == int(js.step) == ITERS
    xyz = np.asarray(js.model.params.xyz)
    span = float(xyz.max() - xyz.min())
    assert float(np.abs(st["params"]["xyz"] - xyz).max()) <= 1e-3 * span
    assert rel(st["mu"]["opacity"], js.opt.mu.opacity) <= 1e-3
    assert ranks[1]["vs_jax"]["state"]["digest"] == st["digest"]


def test_densify_with_pseudo_views_keeps_the_ranks_equal(runs):
    """tests/test_trainer_mesh.py:153-186 at B = 2, with ray jitter."""
    _, _, _, _, ranks = runs
    got = ranks[0]["densify"]
    st = got["state"]
    assert st["step"] == DENSIFY["iterations"]
    assert ranks[1]["densify"]["state"]["digest"] == st["digest"]
    assert got["overflow"] == 0
    losses = got["losses"]      # every step's, through rank 0's logger
    assert len(losses) == DENSIFY["iterations"] and np.isfinite(losses).all()
    assert min(losses) < losses[0]
    assert ranks[1]["densify"]["losses"] == []      # rank 1 has no logger
    assert st["aux"]["denom"].max() > 0
    for v in st["params"].values():
        assert np.isfinite(v).all()


def test_idu_episode_on_a_mesh(runs):
    """tests/test_trainer_mesh.py:117-151 at B = 2: the ranks end equal,
    and rank 0 alone wrote the episode's frames, checkpoint and PLY."""
    root, _, _, _, ranks = runs
    got = ranks[0]["idu"]
    assert got["state"]["step"] == IDU["idu_episode_iterations"]
    assert ranks[1]["idu"]["state"]["digest"] == got["state"]["digest"]
    assert got["state"]["aux"]["denom"].max() > 0
    assert sorted(got["writes"]) == ["_save_frames", "save_checkpoint", "save_ply"]
    assert ranks[1]["idu"]["writes"] == []
    orbit_set = ("tag", "views", "size", "capacity", "overflow", "alpha_coverage")
    for k in orbit_set:
        assert ranks[1]["idu"]["episode"][k] == got["episode"][k], k
    assert got["max_overflow"] == 0
    assert got["episode"]["views"] == 2
    idu_dir = root / "idu" / "idu" / "e60.0_r3.0"
    assert sorted(os.listdir(idu_dir / "render")) == ["00000.png", "00001.png"]
    assert (idu_dir / "render_depth.npy").is_file()
    assert (root / "idu" / "chkpnt14.npz").is_file()


def test_a_viewer_pause_on_rank_0_holds_every_rank(runs):
    _, _, _, _, ranks = runs
    t0, t1 = ranks[0]["pause"]["window"]
    assert t1 - t0 >= PAUSE_S
    assert ranks[1]["pause"]["window"] is None
    starts = ranks[1]["pause"]["starts"]
    assert len(starts) == 5
    # rank 1's third iteration began only after rank 0's viewer let go
    assert starts[1] < t0 and starts[2] >= t1
    assert ranks[1]["pause"]["digest"] == ranks[0]["pause"]["digest"]


def test_one_rank_mesh_equals_the_single_device_trainer(tmp_path):
    scene = _synthetic_scene(np.random.default_rng(1))
    tscene = torch_ranks.scene_from_arrays(scene_arrays(scene), "cpu")
    opt = dict(OPT, iterations=14, densify_from_iter=2, densify_until_iter=12,
               densification_interval=5, densify_grad_threshold=1e-7,
               opacity_reset_interval=9)

    def trainer(name, mesh=None):
        return TTrainer(TModelConfig(model_path=str(tmp_path / name), ray_jitter=True),
                        TOptimizationConfig(**opt), TPipelineConfig(), tscene, rng_seed=4,
                        mesh=mesh)

    single = trainer("single")
    s0 = single.train(single.init_state(), iterations=14)
    mesh = tmesh.make_mesh(1, backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        t1 = trainer("mesh", mesh)
        s1 = t1.train(t1.init_state(), iterations=14)
    finally:
        dist.destroy_process_group()
    assert s1.model.params.capacity > 256    # densify grew the capacity
    assert state_digest(s1) == state_digest(s0)
    assert t1.py_rng.getstate() == single.py_rng.getstate()


def test_cli_data_parallel_writes_once(tmp_path):
    """``cli.train --data_parallel 2 --device cpu``: two gloo ranks, and the
    outputs of rank 0 only (one config, one metrics log, one checkpoint)."""
    _write_scene(tmp_path / "scene")
    model = tmp_path / "model"
    out = train_cli.main(["-s", str(tmp_path / "scene"), "-m", str(model), "--eval",
                          "--iterations", "4", "--test_iterations", "4",
                          "--checkpoint_iterations", "4", "--save_iterations", "4",
                          "--data_parallel", "2", "--device", "cpu", "--quiet"])
    assert out is None
    for name in ("cfg_args.json", "input.ply", "cameras.json", "chkpnt4.npz",
                 "point_cloud/iteration_4/point_cloud.ply", "metrics.jsonl"):
        assert (model / name).is_file(), name
    cfg = json.loads((model / "cfg_args.json").read_text())
    assert cfg["data_parallel"] == 2
    records = [json.loads(line) for line in open(model / "metrics.jsonl")]
    evals = [r for r in records if r["type"] == "eval" and r["split"] == "test"]
    assert len(evals) == 1 and np.isfinite(evals[0]["psnr"])
    assert peek_checkpoint_meta(str(model / "chkpnt4.npz"))["iteration"] == 4
