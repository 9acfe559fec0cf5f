"""Port parity: a single-device Trainer driving a FLUX refiner sharded over
serving ranks (priors/flux_serve.py, train/idu.py), on two gloo ranks
spawned on the CPU, against the JAX package's single controller on 2 of the
8 virtual CPU devices that tests/conftest.py makes.

The ranks run tests/torch_serve_ranks.py (no JAX in a rank): rank 0 holds
the Trainer, the depth predictor and the orchestrator, rank 1 serves the
refiner.  The JAX side, and the port's episode with a whole refiner, run in
the test process meanwhile.  FLUX is tests/test_flux_shard.py's
``tp_config()`` (8 heads, hidden 64, 2 double + 3 single blocks), the VAE
``VAEConfig.tiny()``, frames 32 px.

Tolerances, and why:
  * against JAX's single-device Trainer with ``build_flux_refiner(mesh=<2
    devices>, tp_dtype=None)`` under equal conditions (the two packages'
    noise streams differ, and cancel there): orbit cameras 1e-6 and the
    host-draw stream state exactly (tests/test_torch_idu.py); the renders
    1e-4 (two rasterizers of the same splats); the refined views rel norm
    1e-4 (the equal-conditions refine of tests/test_torch_flux_shard.py)
    and 1e-4 max abs; depths 1e-4; written PNGs within one 8-bit step;
  * against the port's whole refiner with the same seed and distinct
    conditions, one ``run(episodes=1)`` episode: the views within 5e-5 (the
    sharded refine against the whole one, tests/test_torch_flux_shard.py),
    the refined frames more than 1e-3 from the renders; the trained state
    within tests/test_torch_trainer_mesh.py's tolerances (``xyz`` 1e-3 of
    its range, Adam's opacity moment 1e-3 norm-relative);
  * the frames rank 1 serves are bit-equal to rank 0's (their SHA-256);
  * a failure on rank 0 ends rank 1 with ``RuntimeError`` within 10 s
    (the heartbeat period is 1 s; the launch's join timeout is 120 s);
  * under a 0.5 ms heartbeat and a 1 us thread switch interval, 200
    commands arrive whole: equal counts and digests on both ranks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.config import ModelConfig, OptimizationConfig, PipelineConfig
from skyfall_gs_tpu.priors import RenderDepthPredictor as JRenderDepth
from skyfall_gs_tpu.priors import flux as jf
from skyfall_gs_tpu.priors import flux_vae as jv
from skyfall_gs_tpu.priors.flux_refiner import build_flux_refiner as jbuild
from skyfall_gs_tpu.train.idu import IDUOrchestrator as JOrch
from skyfall_gs_tpu.train.loop import Trainer as JTrainer
from skyfall_gs_tpu_torch.config import IDU_CURRICULA
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.priors import flux_vae as tv
from skyfall_gs_tpu_torch.priors.flux_serve import (
    RefinerClient,
    frames_digest,
    serve_or_run,
    serve_refiner,
)
from tests import torch_serve_ranks as sr
from tests.test_flux_shard import tp_config
from tests.test_torch_core import jax_state_to_numpy
from tests.test_torch_flux_shard import _jax_mesh, _np_sd
from tests.test_torch_parallel import in_background, rel
from tests.test_torch_trainer_mesh import IDU, OPT, scene_arrays
from tests.test_train import _synthetic_scene

torch.set_num_threads(1)
JOIN_S = 120.0
SEED = 3
NUM_STEPS = 6
VIEWS_OPT = dict(IDU, idu_refine=True, idu_flow_edit_n_max=2)
EPISODE_OPT = dict(VIEWS_OPT, idu_grid_size=1, datasets_type="ring")
TARGETS = [[0.0, 0.0, 0.0]]
ORBIT = ([70.0, 50.0], [3.0, 3.5], 60.0)     # mixed rings: the shuffle draws from the stream
TAG = "e_mixed"
STRESS_COMMANDS = 200


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks, JAX's views with its tp = 2 refiner, and the port's
    episode with a whole refiner."""
    root = tmp_path_factory.mktemp("flux_serve")
    rng = np.random.default_rng(0)
    cfg = tp_config()
    params = jf.init_flux_params(jax.random.PRNGKey(0), cfg)
    vcfg = jv.VAEConfig.tiny()
    vparams = jv.init_vae_params(jax.random.PRNGKey(1), vcfg)
    scene = _synthetic_scene(np.random.default_rng(0))
    jopt = OptimizationConfig(**dict(OPT, **VIEWS_OPT))
    jtr = JTrainer(ModelConfig(model_path=str(root / "jax")), jopt, PipelineConfig(fuse_steps=1),
                   scene, rng_seed=SEED)
    js = jtr.init_state()
    conds = [dict(txt=rng.normal(0, 0.02, (1, 6, cfg.joint_dim)).astype(np.float32),
                  pooled=rng.normal(0, 0.02, (1, cfg.pooled_dim)).astype(np.float32))
             for _ in range(2)]
    payload = dict(cfg=cfg._asdict(), weights=_np_sd(params, cfg),
                   vae={k: v.numpy() for k, v in tv.state_from_numpy(
                       jax.tree.map(np.asarray, vparams),
                       tv.VAEConfig(**vcfg._asdict())).items()},
                   vae_cfg=vcfg._asdict(), num_steps=NUM_STEPS, conds=conds,
                   scene=scene_arrays(scene), root=str(root), opt=OPT, seed=SEED,
                   init=jax_state_to_numpy(js.model), views_opt=VIEWS_OPT,
                   episode_opt=EPISODE_OPT, targets=TARGETS, orbit=ORBIT, tag=TAG,
                   stress_commands=STRESS_COMMANDS)
    join = in_background(tmesh.launch, sr.serving_runs, 2, (payload,), device="cpu",
                         join_timeout_s=JOIN_S)

    jcond = jf.FluxCond(jnp.asarray(conds[1]["txt"]), jnp.asarray(conds[1]["pooled"]), 5.5)
    jref = jbuild(transformer_params=params, vae_params=vparams, cfg=cfg, vae_cfg=vcfg,
                  num_steps=NUM_STEPS, batch_size=2, seed=7, src_cond=jcond, tar_cond=jcond,
                  mesh=_jax_mesh(2), tp_dtype=None)
    jviews = JOrch(jtr, jref, JRenderDepth()).generate_idu_views(js, TARGETS, *ORBIT, TAG)
    jrenders = [np.clip(np.asarray(jtr._eval_render(js.model, v.camera, jtr.bg).color), 0, 1)
                for v in jviews]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(IDU_CURRICULA, "ring", sr.RING)
        whole = sr.episode(payload, "whole", sr.refiner(payload))
    return dict(root=root, jviews=jviews, jrenders=jrenders, jstream=jtr.py_rng.getstate(),
                whole=whole, ranks=join())


def test_views_match_jax_single_controller(runs):
    """(a) ``generate_idu_views`` inside ``with orch.client:`` on rank 0
    against JAX's single-device Trainer with a tp = 2 refiner."""
    got, jviews, root = runs["ranks"][0]["views"], runs["jviews"], runs["root"]
    assert len(jviews) == len(got["uids"]) == 2
    assert got["py_rng"] == runs["jstream"]
    assert got["overflow"] == 0 and got["names"] == [TAG] * 2
    for i, jv_ in enumerate(jviews):
        assert got["uids"][i] == int(jv_.camera.uid)
        np.testing.assert_allclose(got["full_proj"][i], np.asarray(jv_.camera.full_proj),
                                   atol=1e-6)
        np.testing.assert_allclose(got["renders"][i], runs["jrenders"][i], atol=1e-4)
        assert rel(got["images"][i], jv_.image) <= 1e-4, rel(got["images"][i], jv_.image)
        np.testing.assert_allclose(got["images"][i], jv_.image, atol=1e-4)
        np.testing.assert_allclose(got["depths"][i], jv_.depth, atol=1e-4)
    for kind in ("render", "render_refine"):
        theirs = sr.pngs(str(root), "jax", TAG, kind)
        ours = sr.pngs(str(root), "views", TAG, kind)
        assert ours.shape == theirs.shape == (2, 32, 32, 3)
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
    np.testing.assert_allclose(np.load(root / "views" / "idu" / TAG / "render_depth.npy"),
                               np.stack([v.depth for v in jviews]), atol=1e-4)


def test_served_views_are_rank_0s(runs):
    """Rank 1 served the one command of (a) and of (b), and returned the
    bits rank 0 refined, then stopped on rank 0's exit from the client."""
    r0, r1 = runs["ranks"]
    for part in ("views", "episode"):
        sent, served = r0[part]["client"], r1[part]
        assert sent["commands"] == served["commands"] == 1
        assert sent["frames"] == served["frames"] == 2
        assert sent["bytes"] == 2 * 32 * 32 * 3 * 4
        assert served["digests"] == sent["digests"]
        assert sent["digests"] == [frames_digest(list(r0[part]["images"]))]


def test_episode_matches_the_whole_refiner(runs):
    """(b) ``run(episodes=1)`` of a single-device Trainer through
    ``serve_or_run`` against the same episode with a whole refiner."""
    sharded, whole = runs["ranks"][0]["episode"], runs["whole"]
    assert sharded["images"].shape == (2, 32, 32, 3) and sharded["overflow"] == 0
    np.testing.assert_array_equal(sharded["renders"], whole["renders"])
    np.testing.assert_allclose(sharded["images"], whole["images"], atol=5e-5)
    np.testing.assert_allclose(sharded["depths"], whole["depths"], atol=5e-5)
    assert np.abs(sharded["images"] - sharded["renders"]).max() > 1e-3
    assert np.abs(sharded["pngs"].astype(int) - whole["pngs"].astype(int)).max() <= 1
    a, b = sharded["state"], whole["state"]
    assert a["step"] == b["step"] == EPISODE_OPT["idu_episode_iterations"]
    xyz = b["params"]["xyz"]
    span = float(xyz.max() - xyz.min())
    assert float(np.abs(a["params"]["xyz"] - xyz).max()) <= 1e-3 * span
    assert rel(a["mu"]["opacity"], b["mu"]["opacity"]) <= 1e-3
    assert whole["client"]["commands"] == 1 and whole["client"]["bytes"] == 0


def test_a_rank_0_failure_ends_the_serving_rank(runs):
    """(c) A train step that raises on rank 0 mid-episode: rank 0 re-raises
    it, and rank 1's ``serve_refiner`` raises ``RuntimeError`` at once."""
    r0, r1 = (r["failure"] for r in runs["ranks"])
    assert r0["raised"] == "InjectedFailure"
    assert r1["raised"] == "RuntimeError" and "after 1 commands" in r1["message"]
    assert 0.0 <= r1["at"] - r0["at"] < 10.0


@pytest.mark.parametrize("case, ranks, words", [("single_off_main", [1], "serve_refiner"),
                                                ("other_ranks", [0, 1], "same ranks")])
def test_the_routes_that_still_raise(runs, case, ranks, words):
    """(d) A single-device Trainer off rank 0 of the refiner's mesh, and a
    Trainer mesh of other ranks, raise ``ValueError``."""
    for r, rank in enumerate(runs["ranks"]):
        msg = rank["value_errors"].get(case)
        if r in ranks:
            assert msg is not None and words in msg, msg
        else:
            assert msg is None


def test_heartbeats_never_split_a_command(runs):
    """(e) 200 commands against a heartbeat every 0.5 ms, with the
    interpreter switching threads every microsecond: the serving rank reads
    every command whole, returns the same bits, and saw heartbeats."""
    sent, served = runs["ranks"][0]["stress"], runs["ranks"][1]["stress"]
    assert sent["commands"] == served["commands"] == STRESS_COMMANDS
    assert served["digests"] == sent["digests"] and len(set(sent["digests"])) == STRESS_COMMANDS
    assert served["heartbeats"] > 0


def test_client_without_serving_ranks():
    """Without a mesh (or at tp = 1) the client runs the refiner locally;
    with serving ranks it must be entered first, and only rank 0 drives."""
    class Doubling:
        mesh = None

        def run(self, images, **kwargs):
            return [2 * np.asarray(f) for f in images]

    frames = [np.ones((4, 4, 3), np.float32)]
    local = RefinerClient(Doubling())
    with local:
        np.testing.assert_array_equal(local.run(frames, n_max=2)[0], 2 * frames[0])
    assert local.record == {"commands": 1, "frames": 1, "bytes": 0,
                            "digests": [frames_digest([2 * frames[0]])]}
    assert serve_or_run(Doubling(), lambda x: x + 1, 1) == 2

    ref = Doubling()
    ref.mesh = types.SimpleNamespace(size=2, rank=0, is_main=True)
    with pytest.raises(RuntimeError, match="enter the RefinerClient"):
        RefinerClient(ref).run(frames)
    with pytest.raises(ValueError, match="serve_refiner runs on ranks 1"):
        serve_refiner(ref)
    ref.mesh = types.SimpleNamespace(size=2, rank=1, is_main=False)
    with pytest.raises(ValueError, match="serve_refiner"):
        RefinerClient(ref)
    ref.mesh = types.SimpleNamespace(size=1, rank=0, is_main=True)
    assert RefinerClient(ref).run(frames)[0][0, 0, 0] == 2.0
