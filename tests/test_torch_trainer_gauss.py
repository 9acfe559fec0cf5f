"""Port parity: the Trainer and IDU episodes on a gauss mesh
(``Trainer(mesh=..., mesh_mode="gauss")``), the sharded ``.orbax``
checkpoints they write and resume from, and ``cli.train --shard_gaussians``
(after tests/test_trainer_gauss.py), on gloo ranks spawned on the CPU.

The ranks run tests/torch_gauss_ranks.py's ``trainer_runs`` (no JAX in a
rank) while the JAX gauss-mode Trainer runs here on 2 of the 8 virtual CPU
devices.

Tolerances, and why:
  * against JAX's 2-shard Trainer (``fuse_steps=1``; 12 iterations on
    tests/test_train.py's synthetic scene, no densify, no ray jitter): the
    host stream's final state EXACTLY; ``xyz`` within 1e-3 of its range, as
    tests/test_torch_trainer_mesh.py holds the view mesh (Adam's step does
    not see JAX's factor G on the gradient); Adam's opacity moment and the
    accumulated ``grad_accum`` equal to JAX's / 2, 1e-2 norm-relative
    (twelve steps of two rasterizers; one step is held at 1e-3 in
    tests/test_torch_gauss_shard.py);
  * the ranks' gathered states bit-equal after training (their replicated
    leaves are each rank's own);
  * a 1-shard mesh bit-equal to the single-device Trainer with densify,
    growth, opacity resets and ray jitter on;
  * a resumed ``.orbax`` checkpoint: parameters and moments exact.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from skyfall_gs_tpu.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu.train.loop import Trainer as JTrainer
from skyfall_gs_tpu_torch.cli import train as train_cli
from skyfall_gs_tpu_torch.config import ModelConfig as TModelConfig
from skyfall_gs_tpu_torch.config import OptimizationConfig as TOptimizationConfig
from skyfall_gs_tpu_torch.config import PipelineConfig as TPipelineConfig
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.parallel.sharding import state_digest
from skyfall_gs_tpu_torch.train.checkpoint_sharded import peek_checkpoint_meta_sharded
from skyfall_gs_tpu_torch.train.loop import Trainer as TTrainer
from tests import torch_gauss_ranks, torch_ranks
from tests.test_cli_pipeline import _write_scene
from tests.test_torch_parallel import JOIN_S, in_background, rel
from tests.test_torch_trainer_mesh import scene_arrays
from tests.test_train import _synthetic_scene

torch.set_num_threads(1)
ITERS = 12
OPT = dict(iterations=18, densify_from_iter=10 ** 9, densify_until_iter=0,
           opacity_reset_interval=10 ** 9, lambda_depth=0.5, lambda_opacity=0.01,
           position_lr_max_steps=18)
DENSIFY = dict(iterations=16, lambda_depth=0.1, densify_from_iter=2, densify_until_iter=14,
               densification_interval=6, densify_grad_threshold=1e-7,
               opacity_reset_interval=9, opacity_cooldown_iterations=3)
IDU = dict(iterations=14, idu_episode_iterations=14, idu_densify_until_iter=10,
           densify_from_iter=2, densification_interval=7,
           idu_opacity_reset_interval=10 ** 9, idu_testing_interval=10 ** 9,
           idu_num_cams=2, idu_num_samples_per_view=1, idu_render_size=32,
           idu_train_ratio=0.5, lambda_depth=0.5, idu_refine=False,
           lambda_pseudo_depth=0.1, sample_pseudo_interval=5,
           idu_position_lr_max_steps=14, densify_grad_threshold=1e-7)
PINNED, RESUME_AT = 2048, 8


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    root = tmp_path_factory.mktemp("gauss")
    scene = _synthetic_scene(np.random.default_rng(0))
    payload = dict(scene=scene_arrays(scene), root=str(root), opt=OPT, iters=ITERS,
                   densify_opt=DENSIFY, densify_iters=DENSIFY["iterations"], idu_opt=IDU,
                   pinned_capacity=PINNED, resume_at=RESUME_AT)
    join = in_background(tmesh.launch, torch_gauss_ranks.trainer_runs, 2, (payload,),
                         device="cpu", join_timeout_s=JOIN_S)
    jtr = JTrainer(ModelConfig(model_path=str(root / "jax")), OptimizationConfig(**OPT),
                   PipelineConfig(fuse_steps=1), scene,
                   mesh=Mesh(np.array(jax.devices("cpu")[:2]), ("gauss",)), mesh_mode="gauss")
    js = jtr.train(jtr.init_state(), iterations=ITERS)
    return root, js, jtr.py_rng.getstate(), join()


def test_gauss_trainer_matches_jax_divided_by_g(runs):
    _, js, jstream, ranks = runs
    got = ranks[0]["vs_jax"]
    assert got["py_rng"] == jstream
    st = got["state"]
    assert st["step"] == st["count"] == int(js.step) == ITERS
    assert ranks[1]["vs_jax"]["state"]["digest"] == st["digest"]
    xyz = np.asarray(js.model.params.xyz)
    span = float(xyz.max() - xyz.min())
    assert float(np.abs(st["params"]["xyz"] - xyz).max()) <= 1e-3 * span
    assert rel(st["mu"]["opacity"], np.asarray(js.opt.mu.opacity) / 2) <= 1e-2
    assert rel(st["aux"]["grad_accum"], np.asarray(js.model.aux.grad_accum) / 2) <= 1e-2
    np.testing.assert_array_equal(st["aux"]["denom"], np.asarray(js.model.aux.denom))


def test_densify_and_growth_keep_the_ranks_equal(runs):
    _, _, _, ranks = runs
    got = ranks[0]["densify"]
    st = got["state"]
    assert st["step"] == DENSIFY["iterations"]
    assert ranks[1]["densify"]["state"]["digest"] == st["digest"]
    cap = len(st["aux"]["alive"])
    assert cap > got["cap0"] and cap % 2 == 0       # grown, pads spread over 2 shards
    assert int(st["aux"]["alive"].sum()) != 60
    assert got["overflow"] == 0
    losses = got["losses"]
    assert len(losses) == DENSIFY["iterations"] and np.isfinite(losses).all()
    assert min(losses) < losses[0]
    assert ranks[1]["densify"]["losses"] == []
    for v in st["params"].values():
        assert np.isfinite(v).all()


def test_orbax_resume_with_growth(runs):
    """A checkpoint of a run pinned at 2048 splats resumes into a fresh
    Trainer (capacity 1024): the shards grow to 1024 rows each first."""
    root, _, _, ranks = runs
    for r in ranks:
        got = r["resume"]
        assert got["fresh"] < PINNED and got["rows"] == PINNED // 2
        assert got["start"] == RESUME_AT
        for part in ("params", "mu", "nu"):
            for k, v in got["saved"][part].items():
                np.testing.assert_array_equal(got["restored"][part][k], v, f"{part}/{k}")
        assert got["restored"]["step"] == RESUME_AT
    path = root / "resume" / f"chkpnt{RESUME_AT}.orbax"
    assert peek_checkpoint_meta_sharded(str(path))["capacity"] == PINNED
    assert sorted(p for p in os.listdir(path) if p.startswith("shard")) == [
        "shard-00000-of-00002.npz", "shard-00001-of-00002.npz"]


def test_a_mesh_that_does_not_divide_the_checkpoint_raises(runs):
    root, _, _, _ = runs
    scene = torch_ranks.scene_from_arrays(scene_arrays(_synthetic_scene(
        np.random.default_rng(0))), "cpu")
    three = tmesh.ViewMesh(group=None, host_group=None, rank=0, size=3,
                           device=torch.device("cpu"), backend="gloo", axis="gauss")
    t = TTrainer(TModelConfig(model_path=str(root / "three")), TOptimizationConfig(**OPT),
                 TPipelineConfig(), scene, mesh=three, mesh_mode="gauss")
    with pytest.raises(ValueError, match="not divisible"):
        t.init_state(str(root / "resume" / f"chkpnt{RESUME_AT}.orbax"))


def test_idu_episode_on_a_gauss_mesh(runs):
    root, _, _, ranks = runs
    got = ranks[0]["idu"]
    assert got["state"]["step"] == IDU["idu_episode_iterations"]
    assert ranks[1]["idu"]["state"]["digest"] == got["state"]["digest"]
    assert got["local_digest"] != ranks[1]["idu"]["local_digest"]   # two different shards
    assert got["max_overflow"] == 0
    idu_dir = root / "idu" / "idu" / "e60.0_r3.0"
    assert sorted(os.listdir(idu_dir / "render")) == ["00000.png", "00001.png"]
    ckpt = root / "idu" / "chkpnt14.orbax"
    assert peek_checkpoint_meta_sharded(str(ckpt))["iteration"] == 14
    assert (root / "idu" / "point_cloud" / "iteration_14" / "point_cloud.ply").is_file()
    assert not (root / "idu" / "chkpnt14.npz").exists()


def test_one_shard_trainer_equals_the_single_device_trainer(tmp_path):
    scene = _synthetic_scene(np.random.default_rng(1))
    tscene = torch_ranks.scene_from_arrays(scene_arrays(scene), "cpu")
    opt = dict(OPT, iterations=14, densify_from_iter=2, densify_until_iter=12,
               densification_interval=5, densify_grad_threshold=1e-7,
               opacity_reset_interval=9)

    def trainer(name, mesh=None):
        return TTrainer(TModelConfig(model_path=str(tmp_path / name), ray_jitter=True),
                        TOptimizationConfig(**opt), TPipelineConfig(), tscene, rng_seed=4,
                        mesh=mesh, mesh_mode="gauss")

    single = trainer("single")
    s0 = single.train(single.init_state(), iterations=14)
    mesh = tmesh.make_mesh(1, axis="gauss", backend="gloo", device="cpu", rank=0,
                           init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        t1 = trainer("mesh", mesh)
        s1 = t1.train(t1.init_state(), iterations=14)
    finally:
        dist.destroy_process_group()
    assert s1.model.params.capacity > 1024    # densify grew the capacity
    assert state_digest(s1) == state_digest(s0)
    assert t1.py_rng.getstate() == single.py_rng.getstate()


def test_cli_shard_gaussians_writes_once(tmp_path):
    """``cli.train --shard_gaussians 2 --device cpu``: two gloo ranks, a
    sharded checkpoint with both ranks' rows, one of every other file."""
    _write_scene(tmp_path / "scene")
    model = tmp_path / "model"
    out = train_cli.main(["-s", str(tmp_path / "scene"), "-m", str(model), "--eval",
                          "--iterations", "4", "--test_iterations", "4",
                          "--checkpoint_iterations", "4", "--save_iterations", "4",
                          "--shard_gaussians", "2", "--device", "cpu", "--quiet"])
    assert out is None
    for name in ("cfg_args.json", "input.ply", "cameras.json", "chkpnt4.orbax/index.json",
                 "point_cloud/iteration_4/point_cloud.ply", "metrics.jsonl"):
        assert (model / name).is_file(), name
    assert json.loads((model / "cfg_args.json").read_text())["shard_gaussians"] == 2
    records = [json.loads(line) for line in open(model / "metrics.jsonl")]
    evals = [r for r in records if r["type"] == "eval" and r["split"] == "test"]
    assert len(evals) == 1 and np.isfinite(evals[0]["psnr"])
    meta = peek_checkpoint_meta_sharded(str(model / "chkpnt4.orbax"))
    assert meta["iteration"] == 4 and meta["capacity"] % 2 == 0
    assert len(os.listdir(model / "chkpnt4.orbax")) == 4


def test_shard_gaussians_with_data_parallel_exits(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_cli.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), "--shard_gaussians",
                        "2", "--data_parallel", "2", "--device", "cpu"])
