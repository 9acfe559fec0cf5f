"""Serving ranks for a sharded FLUX refiner under a single-device Trainer.

A sharded refiner (``build_flux_refiner(mesh=...)``) is SPMD: every rank of
its mesh must be inside ``run`` with the same frames.  The JAX package drives
its ``tp`` mesh from one controller, so a single-device Trainer calls
``run`` alone.  Here rank 0 trains and ranks 1..tp-1 serve:

  * :func:`serve_refiner` is the loop of ranks 1..tp-1.  It waits for a flag
    that rank 0 broadcasts on ``refiner.mesh.host_group``: ``_REFINE`` (the
    ``n_*`` keyword arguments and the frames follow; it calls
    ``refiner.run`` with them), ``_WORKING`` (a heartbeat), ``_DONE`` (stop:
    it returns its record) or ``_FAILED`` (it raises ``RuntimeError``);
  * :class:`RefinerClient` is rank 0's side, with ``FlowEditRefiner.run``'s
    contract.  Each ``run`` broadcasts ``_REFINE``, the arguments and the
    frames, then calls the local ``refiner.run`` with every rank inside.
    While it is entered, a thread sends a heartbeat every
    ``parallel.mesh.HEARTBEAT_S``, so the serving ranks wait through a whole
    episode one bounded collective at a time.  Its outermost exit sends
    ``_DONE``, or ``_FAILED`` when an exception leaves it, so no rank hangs
    when the Trainer raises.  One lock covers each heartbeat and each whole
    command (its ``refiner.run`` included): gloo matches collectives by
    their order, and a heartbeat sent mid-command would be read as the next
    flag.  Without a mesh, or at tp = 1, it runs the refiner locally, with
    no protocol;
  * :func:`serving_client` is the one client of a refiner on this rank, so
    the orchestrator and :func:`serve_or_run` enter the same one (entering
    nests; only the outermost exit ends the serving ranks);
  * :func:`serve_or_run` is the split a ``parallel.mesh.launch``ed function
    makes after every rank has built the refiner: rank 0 runs the caller's
    Stage 2 inside the client, the other ranks serve.

A command that fails inside ``refiner.run`` leaves the other ranks in a
collective of the refiner's mesh; they end at that group's timeout.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from skyfall_gs_tpu_torch.parallel.mesh import (
    _DONE,
    _FAILED,
    _REFINE,
    _WORKING,
    HEARTBEAT_S,
)


def frames_digest(frames: Sequence[np.ndarray]) -> str:
    """SHA-256 of a batch of frames' bytes, in order."""
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


def _flag(mesh, value: Optional[int] = None) -> int:
    """Rank 0's ``value`` on every rank of ``mesh``'s host group."""
    t = torch.tensor([0 if value is None else value], dtype=torch.int32)
    dist.broadcast(t, mesh.root, group=mesh.host_group)
    return int(t)


def serve_refiner(refiner) -> dict:
    """The loop of ranks 1..tp-1 of ``refiner.mesh``: refine what rank 0's
    :class:`RefinerClient` sends until it stops.

    Returns the record of the commands served (``commands``, ``frames``,
    ``heartbeats`` and the ``digests`` of each returned batch) on
    ``_DONE``; raises ``RuntimeError`` on ``_FAILED``."""
    mesh = refiner.mesh
    if mesh is None or mesh.is_main:
        raise ValueError("serve_refiner runs on ranks 1..tp-1 of a sharded refiner's mesh; "
                         "rank 0 drives them through RefinerClient")
    record = {"commands": 0, "frames": 0, "heartbeats": 0, "digests": []}
    while True:
        flag = _flag(mesh)
        if flag == _WORKING:
            record["heartbeats"] += 1
        elif flag == _REFINE:
            kwargs = mesh.broadcast_object()
            frames = mesh.broadcast_arrays(None)
            out = refiner.run(frames, **kwargs)
            record["commands"] += 1
            record["frames"] += len(frames)
            record["digests"].append(frames_digest(out))
        elif flag == _DONE:
            return record
        elif flag == _FAILED:
            raise RuntimeError("rank 0 of the sharded refiner's mesh failed; its serving "
                               f"ranks stop after {record['commands']} commands")
        else:
            raise RuntimeError(f"unknown command {flag} from rank 0")


class RefinerClient:
    """Rank 0's ``refiner``: ``run`` has ``FlowEditRefiner.run``'s contract
    and drives ranks 1..tp-1 of ``refiner.mesh`` in :func:`serve_refiner`
    (locally without a mesh or at tp = 1).  Enter it around the work during
    which they serve; ``record`` counts the commands sent, their frames and
    the frames' bytes broadcast, and the digest of each returned batch."""

    def __init__(self, refiner):
        self.refiner = refiner
        mesh = getattr(refiner, "mesh", None)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and not self.mesh.is_main:
            raise ValueError(f"rank {self.mesh.rank} of the sharded refiner's mesh serves it: "
                             "call priors.flux_serve.serve_refiner(refiner) there")
        self.record = {"commands": 0, "frames": 0, "bytes": 0, "digests": []}
        self._depth = 0
        self._closed = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _heartbeat(self) -> None:
        try:
            while not self._stop.wait(HEARTBEAT_S):
                with self._lock:
                    _flag(self.mesh, _WORKING)
        except RuntimeError as e:     # a serving rank is gone: raised at the next command
            self._error = e

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError("the heartbeat to the serving ranks failed") from self._error

    def __enter__(self) -> "RefinerClient":
        if self.mesh is not None:
            if self._closed:
                raise RuntimeError("this client has stopped its serving ranks")
            if self._depth == 0:
                self._stop.clear()
                self._beat = threading.Thread(target=self._heartbeat, daemon=True)
                self._beat.start()
        self._depth += 1
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._depth -= 1
        if self.mesh is None or self._depth:
            return False
        self._stop.set()
        self._beat.join()
        self._closed = True
        if exc_type is None:
            self._check()
            _flag(self.mesh, _DONE)
        else:
            try:
                _flag(self.mesh, _FAILED)
            except RuntimeError:
                pass    # a serving rank is gone as well; the original error propagates
        return False

    def run(self, images: Sequence[np.ndarray], **kwargs) -> List[np.ndarray]:
        """``refiner.run(images, **kwargs)`` with every rank of the mesh inside."""
        if self.mesh is None:
            out = self.refiner.run(images, **kwargs)
        else:
            if self._depth == 0:
                raise RuntimeError("enter the RefinerClient (with client: ...) before run: "
                                   "the serving ranks wait for its commands only then")
            frames = [np.ascontiguousarray(f) for f in images]
            with self._lock:
                self._check()
                _flag(self.mesh, _REFINE)
                self.mesh.broadcast_object(kwargs)
                self.mesh.broadcast_arrays(frames)
                out = self.refiner.run(frames, **kwargs)
            self.record["bytes"] += sum(f.nbytes for f in frames)
        self.record["commands"] += 1
        self.record["frames"] += len(images)
        self.record["digests"].append(frames_digest(out))
        return out


def serving_client(refiner) -> RefinerClient:
    """The one :class:`RefinerClient` of ``refiner`` on this rank, made on
    first use."""
    client = getattr(refiner, "_serving_client", None)
    if client is None:
        client = RefinerClient(refiner)
        refiner._serving_client = client
    return client


def serve_or_run(refiner, fn: Callable, *args, **kwargs):
    """The split of the ranks of ``refiner.mesh`` once each has built the
    sharded refiner: rank 0 returns ``fn(*args, **kwargs)``, run inside
    :func:`serving_client` (``fn`` builds the single-device Trainer, the
    depth predictor and the ``IDUOrchestrator`` and trains; the serving
    ranks wait through all of it); ranks 1..tp-1 return
    :func:`serve_refiner`'s record."""
    mesh = getattr(refiner, "mesh", None)
    if mesh is not None and not mesh.is_main:
        return serve_refiner(refiner)
    with serving_client(refiner):
        return fn(*args, **kwargs)
