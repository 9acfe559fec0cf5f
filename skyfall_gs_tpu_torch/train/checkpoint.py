"""Training checkpoints: full-state save/restore, interchangeable with the
JAX package's.

Port of ``skyfall_gs_tpu/train/checkpoint.py``.  A checkpoint is one
``.npz`` (no pickle) holding every parameter tensor (the appearance
embeddings and MLP included), the densification statistics, the complete
Adam state and the step, under the JAX package's flattened state-dict keys

    model/params/xyz, ..., model/params/appearance_mlp/l0/w,
    model/aux/alive, ..., opt/mu/xyz, ..., opt/nu/..., opt/count, step

plus ``__meta__``, a JSON string with the iteration, the SH degrees, the
appearance configuration, the spatial LR scale, the capacity and the
number of cameras.  A checkpoint written by either package loads into the
other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from skyfall_gs_tpu_torch.model.gaussians import flat_fields
from skyfall_gs_tpu_torch.train.step import TrainState


def _leaves(train_state: TrainState) -> list:
    """``(key, tensor)`` for every tensor of the state, keyed as in the
    file."""
    parts = (("model/params", train_state.model.params),
             ("model/aux", train_state.model.aux),
             ("opt/mu", train_state.opt.mu), ("opt/nu", train_state.opt.nu))
    return [(f"{prefix}/{path}", t) for prefix, part in parts
            for path, t in flat_fields(part)]


def _counters(train_state: TrainState) -> dict:
    return {"opt/count": np.asarray(train_state.opt.count, np.int32),
            "step": np.asarray(train_state.step, np.int32)}


def _state_meta(train_state: TrainState, iteration: int, capacity: int) -> dict:
    model = train_state.model
    emb = model.params.appearance_embeddings
    return {
        "iteration": int(iteration),
        "active_sh_degree": model.active_sh_degree,
        "max_sh_degree": model.max_sh_degree,
        "appearance": list(model.appearance),
        "spatial_lr_scale": model.spatial_lr_scale,
        "capacity": int(capacity),
        "num_cameras": int(emb.shape[0]) if emb is not None else 0,
    }


def save_checkpoint(path: str, train_state: TrainState, iteration: int) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {k: t.detach().cpu().numpy() for k, t in _leaves(train_state)}
    flat.update(_counters(train_state))
    meta = _state_meta(train_state, iteration, train_state.model.params.capacity)
    np.savez_compressed(path, __meta__=json.dumps(meta), **flat)


@torch.no_grad()
def load_checkpoint(path: str, template: TrainState) -> Tuple[TrainState, int]:
    """Restore IN PLACE into ``template`` (same capacity and appearance
    configuration; tensors the file lacks keep the template's values).
    Returns (state, iteration)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for key, t in _leaves(template):
            if key not in data.files:
                continue
            _copy_into(t, data[key], f"{path}: {key}")
        _restore_counters(template, data)
    _restore_meta(template, meta)
    return template, meta["iteration"]


def _copy_into(t: torch.Tensor, arr: np.ndarray, what: str) -> None:
    if tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"{what} has shape {arr.shape}, the state {tuple(t.shape)}")
    t.copy_(torch.from_numpy(arr).to(t.dtype))


def _restore_counters(template: TrainState, data) -> None:
    if "opt/count" in data.files:
        template.opt.count = int(data["opt/count"])
    if "step" in data.files:
        template.step = int(data["step"])


def _restore_meta(template: TrainState, meta: dict) -> None:
    template.model = dataclasses.replace(
        template.model, active_sh_degree=meta["active_sh_degree"],
        max_sh_degree=meta["max_sh_degree"], spatial_lr_scale=meta["spatial_lr_scale"])


def peek_checkpoint_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))
