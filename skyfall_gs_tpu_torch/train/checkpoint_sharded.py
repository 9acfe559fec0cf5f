"""Sharded training checkpoints: every rank writes its own rows.

Counterpart of ``skyfall_gs_tpu/train/checkpoint_sharded.py``, whose orbax
format the port does not read (neither orbax nor tensorstore is a
dependency of the port): the port keeps JAX's names (``chkpnt<it>.orbax``
directories, ``save_checkpoint_sharded`` / ``load_checkpoint_sharded`` /
``peek_checkpoint_meta_sharded``) with a format of its own.  A directory
holds

  * ``shard-<k>-of-<G>.npz``: rank k's rows of every per-splat tensor
    (parameters, densification state, Adam moments), under the ``.npz``
    format's keys (``train/checkpoint.py``), written by rank k;
  * ``replicated.npz``: the appearance camera table and MLP with their
    moments, the Adam count and the step, written by rank 0;
  * ``index.json``, written by rank 0 once every shard is on disk: the
    format, the ``.npz`` format's metadata (the global capacity among it)
    and each shard file's global row range ``[start, stop)``.

Nothing is gathered on save.  Restore reads the rows of the template's
shard from whichever files hold them, so a checkpoint written on G ranks
restores on any number of ranks that divides its capacity, one included.
The gathered contents equal the ``.npz`` of the same state bit for bit;
the ``.npz`` stays the interchange with the JAX package (its orbax
directories raise here, saying so).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from skyfall_gs_tpu_torch.parallel.gauss_shard import _is_splat_leaf
from skyfall_gs_tpu_torch.train.checkpoint import (
    _copy_into,
    _counters,
    _leaves,
    _restore_counters,
    _restore_meta,
    _state_meta,
)
from skyfall_gs_tpu_torch.train.step import TrainState

FORMAT = "skyfall_gs_tpu_torch sharded checkpoint v1"
_INDEX = "index.json"
_REPLICATED = "replicated.npz"


def _shard_name(k: int, g: int) -> str:
    return f"shard-{k:05d}-of-{g:05d}.npz"


def _savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _split(train_state: TrainState):
    """``(per-splat leaves, replicated leaves)`` as ``{key: tensor}``."""
    n = train_state.model.params.capacity
    rows, shared = {}, {}
    for key, t in _leaves(train_state):
        (rows if _is_splat_leaf(key, t, n) else shared)[key] = t
    return rows, shared


def save_checkpoint_sharded(path: str, train_state: TrainState, iteration: int,
                            mesh=None) -> None:
    """Write ``train_state`` (this rank's shard on a gauss ``mesh``, every
    rank calling; the whole state with ``mesh=None``) into the directory
    ``path``."""
    path = os.path.abspath(path)
    k, g = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    n = train_state.model.params.capacity
    os.makedirs(path, exist_ok=True)
    rows, shared = _split(train_state)
    _savez(os.path.join(path, _shard_name(k, g)),
           {key: t.detach().cpu().numpy() for key, t in rows.items()})
    if k == 0:
        arrays = {key: t.detach().cpu().numpy() for key, t in shared.items()}
        arrays.update(_counters(train_state))
        _savez(os.path.join(path, _REPLICATED), arrays)
    if mesh is not None:
        mesh.barrier()
    if k == 0:
        index = {"format": FORMAT, "meta": _state_meta(train_state, iteration, n * g),
                 "shards": [{"file": _shard_name(j, g), "rows": [j * n, (j + 1) * n]}
                            for j in range(g)],
                 "replicated": _REPLICATED}
        tmp = os.path.join(path, _INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, os.path.join(path, _INDEX))
    if mesh is not None:
        mesh.barrier()


def _read_index(path: str) -> dict:
    index_path = os.path.join(path, _INDEX)
    if not os.path.isfile(index_path):
        if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m)) for m in (
                "_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "state", "meta")):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the PyTorch port reads "
                "only its own sharded format (an index.json beside shard-*.npz). Convert it "
                "with the JAX package (load_checkpoint_sharded, then "
                "train.checkpoint.save_checkpoint to a .npz), which the port loads")
        raise FileNotFoundError(f"no sharded checkpoint at {path} (no {_INDEX})")
    with open(index_path) as f:
        index = json.load(f)
    if index.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format {index.get('format')!r}")
    return index


def peek_checkpoint_meta_sharded(path: str) -> dict:
    return _read_index(os.path.abspath(path))["meta"]


@torch.no_grad()
def load_checkpoint_sharded(path: str, template: TrainState, mesh=None) -> Tuple[TrainState, int]:
    """Restore IN PLACE into ``template``: this rank's shard on a gauss
    ``mesh`` (every rank calling), the whole state with ``mesh=None``.  The
    template's rows times the mesh size must equal the checkpoint's
    capacity (grow it first, with ``sharded_grow_capacity`` on a mesh);
    tensors the checkpoint lacks keep the template's values.  Returns
    ``(state, iteration)``."""
    path = os.path.abspath(path)
    index = _read_index(path)
    meta = index["meta"]
    k, g = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    n = template.model.params.capacity
    if n * g != meta["capacity"]:
        raise ValueError(f"{path} holds {meta['capacity']} rows; the template's {g} shard(s) "
                         f"of {n} rows hold {n * g}")
    lo, hi = k * n, (k + 1) * n
    rows, shared = _split(template)
    for shard in index["shards"]:
        start, stop = shard["rows"]
        a, b = max(start, lo), min(stop, hi)
        if a >= b:
            continue
        with np.load(os.path.join(path, shard["file"]), allow_pickle=False) as data:
            for key, t in rows.items():
                if key in data.files:
                    part = data[key][a - start:b - start]
                    _copy_into(t[a - lo:b - lo], part, f"{path}/{shard['file']}: {key}")
    with np.load(os.path.join(path, index["replicated"]), allow_pickle=False) as data:
        for key, t in shared.items():
            if key in data.files:
                _copy_into(t, data[key], f"{path}/{index['replicated']}: {key}")
        _restore_counters(template, data)
    _restore_meta(template, meta)
    return template, meta["iteration"]
