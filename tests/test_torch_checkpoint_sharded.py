"""Sharded checkpoints (train/checkpoint_sharded.py): written by every rank
of a gauss mesh without a gather, restored to any shard count and through
capacity growth, and equal bit for bit to the ``.npz`` format's contents
(tests/test_checkpoint_sharded.py on the port).

Two gloo ranks save the shards of a state (moments offset so they are not
zero, step 77) and of its grown copy, then restore both into zeroed shards;
this process restores the same directories whole, and in 4 shards by rank
(a restore reads files only, no collective).  Every comparison is exact.
A JAX orbax directory raises with a message that says what it is.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from skyfall_gs_tpu_torch.model import gaussians as tg
from skyfall_gs_tpu_torch.model.appearance import AppearanceConfig
from skyfall_gs_tpu_torch.model.densify import grow_capacity
from skyfall_gs_tpu_torch.parallel import mesh as tmesh
from skyfall_gs_tpu_torch.train import checkpoint as ck
from skyfall_gs_tpu_torch.train import checkpoint_sharded as cks
from skyfall_gs_tpu_torch.train.step import init_train_state
from tests import torch_gauss_ranks
from tests.torch_ranks import _host_state

torch.set_num_threads(1)
JOIN_S = 120.0


def _payload(root) -> dict:
    rng = np.random.default_rng(0)
    model = tg.create_from_points(
        rng.normal(size=(30, 3)).astype(np.float32), rng.uniform(size=(30, 3)).astype(np.float32),
        capacity=64, appearance=AppearanceConfig(enabled=True, embedding_dim=8, hidden=16),
        num_cameras=5)
    model.active_sh_degree = 2
    return dict(state=tg.state_to_numpy(model), mu_offset=0.25, step=77, count=77,
                iteration=77, grow_to=128, root=str(root))


def _template(p: dict, capacity: int = 64):
    ts = torch_gauss_ranks._zeroed(torch_gauss_ranks._train_state(p))
    if capacity != ts.model.params.capacity:
        ts.model, ts.opt = grow_capacity(ts.model, ts.opt, capacity)
    return ts


def _fake_mesh(rank: int, size: int):
    """What a restore reads of a mesh: its rank and size."""
    return types.SimpleNamespace(rank=rank, size=size)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    p = _payload(root)
    ranks = tmesh.launch(torch_gauss_ranks.checkpoint_roundtrip, 2, (p,), device="cpu",
                         join_timeout_s=JOIN_S)
    return p, ranks


def test_save_on_two_ranks_restores_on_two(saved):
    p, ranks = saved
    for r in ranks:
        assert r["saved"]["digest"] == ranks[0]["saved"]["digest"]
        assert r["restored_plain"]["state"]["digest"] == r["saved"]["digest"]
        assert r["restored_grown"]["state"]["digest"] == r["grown"]["digest"]
        assert r["restored_plain"]["iteration"] == 77 and r["restored_plain"]["sh"] == 2
    st = ranks[0]["restored_plain"]["state"]
    assert st["step"] == st["count"] == 77


def test_index_and_files(saved):
    p, _ = saved
    path = os.path.join(p["root"], "plain.orbax")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    assert [s["rows"] for s in index["shards"]] == [[0, 32], [32, 64]]
    assert sorted(os.listdir(path)) == ["index.json", "replicated.npz",
                                        "shard-00000-of-00002.npz", "shard-00001-of-00002.npz"]
    assert cks.peek_checkpoint_meta_sharded(path) == index["meta"]
    assert index["meta"]["capacity"] == 64 and index["meta"]["num_cameras"] == 5


@pytest.mark.parametrize("name,capacity", [("plain", 64), ("grown", 128)])
def test_restore_on_one_rank(saved, name, capacity):
    p, ranks = saved
    ts, it = cks.load_checkpoint_sharded(os.path.join(p["root"], f"{name}.orbax"),
                                         _template(p, capacity))
    assert it == 77 and ts.model.params.capacity == capacity
    want = ranks[0]["saved" if name == "plain" else "grown"]
    assert _host_state(ts)["digest"] == want["digest"]


def test_restore_in_four_shards_reads_across_files(saved):
    p, ranks = saved
    path = os.path.join(p["root"], "plain.orbax")
    parts = []
    for k in range(4):
        tmpl = torch_gauss_ranks.gs.shard_train_state(_template(p), _fake_mesh(k, 4))
        parts.append(cks.load_checkpoint_sharded(path, tmpl, _fake_mesh(k, 4))[0])
    want = ranks[0]["saved"]
    for key, v in want["params"].items():
        got = [dict(tg.flat_fields(s.model.params))[key].numpy() for s in parts]
        if key.startswith("appearance"):
            for g in got:
                np.testing.assert_array_equal(g, v, key)
        else:
            np.testing.assert_array_equal(np.concatenate(got), v, key)
    with pytest.raises(ValueError, match="holds 64 rows"):
        cks.load_checkpoint_sharded(path, _template(p), _fake_mesh(0, 2))


def test_gathered_contents_equal_the_npz_bit_for_bit(saved, tmp_path):
    p, ranks = saved
    full = torch_gauss_ranks._train_state(p)
    full.step = full.opt.count = 77
    ck.save_checkpoint(str(tmp_path / "same.npz"), full, 77)
    path = os.path.join(p["root"], "plain.orbax")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    shards = [np.load(os.path.join(path, s["file"])) for s in index["shards"]]
    shared = np.load(os.path.join(path, "replicated.npz"))
    with np.load(tmp_path / "same.npz") as npz:
        assert json.loads(str(npz["__meta__"])) == index["meta"]
        keys = set(npz.files) - {"__meta__"}
        assert keys == set(shards[0].files) | set(shared.files)
        for key in keys:
            got = (shared[key] if key in shared.files
                   else np.concatenate([s[key] for s in shards]))
            assert got.dtype == npz[key].dtype, key
            np.testing.assert_array_equal(got, npz[key], key)


def test_a_jax_orbax_directory_raises(tmp_path):
    """The JAX package's orbax format is not read: the error says so and
    names the .npz route."""
    import jax
    from jax.sharding import Mesh

    from skyfall_gs_tpu.model.gaussians import create_from_points
    from skyfall_gs_tpu.parallel.gauss_shard import shard_train_state
    from skyfall_gs_tpu.train.checkpoint_sharded import save_checkpoint_sharded
    from skyfall_gs_tpu.train.step import init_train_state as jinit

    rng = np.random.default_rng(0)
    st = jinit(create_from_points(rng.normal(size=(30, 3)).astype(np.float32),
                                  rng.uniform(size=(30, 3)).astype(np.float32), capacity=64))
    path = str(tmp_path / "chkpnt5.orbax")
    save_checkpoint_sharded(path, shard_train_state(st, Mesh(np.array(jax.devices()[:2]),
                                                             ("gauss",))), 5)
    for fn in (lambda: cks.peek_checkpoint_meta_sharded(path),
               lambda: cks.load_checkpoint_sharded(path, init_train_state(
                   tg.create_from_points(np.zeros((4, 3), np.float32),
                                         np.zeros((4, 3), np.float32), capacity=64)))):
        with pytest.raises(ValueError, match="orbax checkpoint of the JAX package.*npz"):
            fn()
    with pytest.raises(FileNotFoundError, match="no sharded checkpoint"):
        cks.peek_checkpoint_meta_sharded(str(tmp_path / "missing.orbax"))
