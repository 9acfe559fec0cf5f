"""Process meshes for view-parallel training, and the multi-host bootstrap.

Port of ``skyfall_gs_tpu/parallel/mesh.py``.  JAX drives every device of a
mesh from one controller; PyTorch runs one process per device under
``torch.distributed`` instead:

  * a :class:`ViewMesh` is one rank's view of the ``data`` axis: its
    process group, rank, size and device.  Every rank builds it with
    :func:`make_mesh`.  Backends: NCCL for CUDA (one process per visible
    GPU, rank r on ``cuda:r``), gloo for the CPU.  Every rank on one CUDA
    device happens only when a caller asks for ``backend="gloo"`` by name
    (NCCL refuses two ranks on one device);
  * :func:`launch` starts the ranks of one host with ``torch.multiprocessing``
    (spawn) and returns each rank's result; a rank that fails, or a join
    past its timeout, fails the whole launch;
  * multi-host pods: :func:`initialize_distributed` maps the
    ``SKYFALL_COORDINATOR`` / ``SKYFALL_NUM_PROCESSES`` /
    ``SKYFALL_PROCESS_ID`` environment (what :func:`multihost_slot_envs`
    emits for ``parallel/launcher.py``) onto a TCP rendezvous at the
    coordinator.  Each host's process starts one rank per local device:
    global rank = ``process_id * local + local_rank``.

Every process group gets an explicit timeout (``DEFAULT_TIMEOUT_S``), so a
rank that dies makes the others fail in bounded time.  Host work that runs
on rank 0 alone and may take longer (IDU view generation, a paused viewer)
goes through :meth:`ViewMesh.on_main`: rank 0 sends a heartbeat while it
works, and the others wait for it one bounded collective at a time.
"""

from __future__ import annotations

import datetime
import gc
import os
import pickle
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Environment keys consumed by initialize_distributed(); emitted per-process
# by multihost_slot_envs() and forwarded by parallel/launcher.py slot_envs.
ENV_COORDINATOR = "SKYFALL_COORDINATOR"
ENV_NUM_PROCESSES = "SKYFALL_NUM_PROCESSES"
ENV_PROCESS_ID = "SKYFALL_PROCESS_ID"

DEFAULT_TIMEOUT_S = 300.0   # every collective, and every wait for rank 0's heartbeat
HEARTBEAT_S = 1.0           # rank 0's heartbeat period inside on_main
_WORKING, _DONE, _FAILED = 0, 1, 2


def pod_config(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """``(coordinator, num_processes, process_id)`` of a multi-host pod from
    the arguments or the ``SKYFALL_*`` environment, or None for a
    single-process run (nothing configured, or ``num_processes <= 1``).
    Half a configuration raises ``RuntimeError``: training alone while the
    rest of the pod waits at the coordinator is a partition, not a
    fallback."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if not coordinator_address and num_processes is None and process_id is None:
        return None
    if num_processes is not None and num_processes <= 1:
        return None
    if not coordinator_address or num_processes is None or process_id is None:
        raise RuntimeError(
            "partial multi-host configuration: need all of "
            f"{ENV_COORDINATOR}/{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} "
            f"(got coordinator={coordinator_address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})")
    return coordinator_address, num_processes, process_id


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_size: int = 1,
    local_rank: int = 0,
    device="cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join a multi-host pod if one is configured; no-op otherwise.

    Falls back to the ``SKYFALL_*`` environment when arguments are omitted
    (:func:`pod_config`).  This process becomes global rank
    ``process_id * local_size + local_rank`` of ``num_processes *
    local_size``, with a TCP rendezvous at the coordinator (process 0's
    host).  The backend is NCCL for a CUDA ``device`` and gloo for the CPU
    unless ``backend`` names one.

    Returns:
        True iff ``torch.distributed.init_process_group`` was called.
    """
    pod = pod_config(coordinator_address, num_processes, process_id)
    if pod is None:
        return False
    coord, n, pid = pod
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend or _backend_for(device), init_method=f"tcp://{coord}",
                            world_size=n * local_size, rank=pid * local_size + local_rank,
                            timeout=_timeout(timeout_s))
    return True


def multihost_slot_envs(hosts: List[str], coordinator_port: int = 8476) -> List[Dict[str, str]]:
    """Per-process environment dicts for a multi-host training job.

    Process 0's host is the coordinator.  Feed the result to
    ``parallel.launcher.run_scene_jobs(slot_envs=...)`` (one slot per host)
    or export it into each host's job environment; ``cli.train`` calls
    :func:`initialize_distributed`, which picks these up.
    """
    coord = f"{hosts[0]}:{coordinator_port}"
    return [{ENV_COORDINATOR: coord, ENV_NUM_PROCESSES: str(len(hosts)),
             ENV_PROCESS_ID: str(i)} for i in range(len(hosts))]


# ----------------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------------

@dataclass
class ViewMesh:
    """One rank's view of a 1-D ``data`` mesh.

    ``group`` carries the training collectives on ``device`` (NCCL, or
    gloo); ``host_group`` is a gloo group for host values (flags,
    objects, host arrays) and for :meth:`on_main`'s heartbeat.
    ``traffic`` counts the collectives on ``group`` and their bytes.
    """

    group: Any
    host_group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "data"
    traffic: Dict[str, int] = field(default_factory=lambda: {"collectives": 0, "bytes": 0})

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _on_group(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the group's backend takes it: gloo reduces CUDA
        tensors only for some collectives, so they go through the host."""
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def _count(self, t: torch.Tensor) -> None:
        self.traffic["collectives"] += 1
        self.traffic["bytes"] += t.numel() * t.element_size()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce ``t`` in place (``op`` "sum" or "max"); every rank
        ends with the same bits."""
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        self._count(t)
        src = self._on_group(t)
        dist.all_reduce(src, op=rop, group=self.group)
        if src is not t:
            t.copy_(src)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._count(t)
        buf = self._on_group(t)
        dist.broadcast(buf, src, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: every rank's ``t`` in rank order."""
        self._count(t)
        src = self._on_group(t.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def max_int(self, value: int) -> int:
        """The largest of every rank's ``value`` (a host int)."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t.item())

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled: host values only)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def broadcast_arrays(self, arrays: Optional[Sequence[np.ndarray]]) -> List[np.ndarray]:
        """Rank 0's host arrays on every rank, one collective per array (a
        stack of IDU views runs to gigabytes); other ranks pass None."""
        meta = self.broadcast_object(
            [(a.shape, a.dtype.str) for a in arrays] if self.rank == 0 else None)
        out = []
        for i, (shape, dtype) in enumerate(meta):
            if self.rank == 0:
                t = torch.from_numpy(np.ascontiguousarray(arrays[i]))
            else:
                t = torch.from_numpy(np.empty(shape, np.dtype(dtype)))
            dist.broadcast(t, 0, group=self.host_group)
            out.append(t.numpy())
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def on_main(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` on rank 0 while the other ranks wait;
        returns its result there and None elsewhere.

        Rank 0 sends a heartbeat every ``HEARTBEAT_S`` from a thread while
        ``fn`` runs, so the wait may outlast the collective timeout but a
        dead rank 0 still ends it within one timeout.  If ``fn`` raises on
        rank 0, every other rank raises ``RuntimeError`` too."""
        if self.size == 1:
            return fn(*args, **kwargs)
        flag = torch.zeros(1, dtype=torch.int32)
        if self.rank != 0:
            while True:
                dist.broadcast(flag, 0, group=self.host_group)
                if int(flag) == _DONE:
                    return None
                if int(flag) == _FAILED:
                    raise RuntimeError("rank 0 failed in host work the other ranks waited for")

        done = threading.Event()

        def heartbeat():
            while not done.wait(HEARTBEAT_S):
                dist.broadcast(torch.tensor([_WORKING], dtype=torch.int32), 0,
                               group=self.host_group)

        beat = threading.Thread(target=heartbeat, daemon=True)
        beat.start()
        status = _FAILED
        try:
            result = fn(*args, **kwargs)
            status = _DONE
        finally:
            done.set()
            beat.join()
            dist.broadcast(torch.tensor([status], dtype=torch.int32), 0, group=self.host_group)
        return result


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: a CUDA device without an index is
    ``cuda:<rank>``; any other device is taken as given."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "data",
    backend: Optional[str] = None,
    device=None,
    *,
    rank: Optional[int] = None,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> ViewMesh:
    """Build this rank's :class:`ViewMesh` over ``n_devices`` ranks.

    With no default process group yet, ``rank`` and ``init_method`` (a
    ``file://`` or ``tcp://`` rendezvous) start one; otherwise the existing
    group is used (after :func:`initialize_distributed`) and must hold
    ``n_devices`` ranks when given.  ``device`` defaults to ``cuda:<rank>``;
    the backend is NCCL for CUDA and gloo for the CPU unless ``backend``
    names one.  NCCL on a device that is not visible raises, as asking for
    more devices than exist does in JAX.
    """
    if not dist.is_initialized():
        if n_devices is None or rank is None or init_method is None:
            raise RuntimeError("make_mesh: no process group yet; pass n_devices, rank and "
                               "init_method, or call initialize_distributed first")
        dev = _rank_device(device, rank)
        backend = backend or _backend_for(dev)
        _check_device(dev, backend, n_devices)
        dist.init_process_group(backend, init_method=init_method, world_size=n_devices,
                                rank=rank, timeout=_timeout(timeout_s))
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} ranks, the process group has {size}")
    dev = _rank_device(device, rank % max(torch.cuda.device_count(), 1))
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"backend {backend!r} asked for, the process group runs {have!r}")
    _check_device(dev, have, size)
    host = dist.new_group(backend="gloo", timeout=_timeout(timeout_s))
    return ViewMesh(group=dist.group.WORLD, host_group=host, rank=rank, size=size,
                    device=dev, backend=have, axis=axis)


def _check_device(dev: torch.device, backend: str, n: int) -> None:
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL needs CUDA devices, got {dev}")
        have = torch.cuda.device_count()
        if dev.index is None or dev.index >= have:
            raise ValueError(f"need {n} devices, have {have} (rank device {dev})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


# ----------------------------------------------------------------------------
# Launching the ranks of one host
# ----------------------------------------------------------------------------

def _local_devices(device, nprocs: int, backend: Optional[str]) -> List[torch.device]:
    devs = [_rank_device(device, r) for r in range(nprocs)]
    if (backend or _backend_for(devs[0])) == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if nprocs > have:
            raise ValueError(f"need {nprocs} devices, have {have}")
        if len(set(devs)) < nprocs:
            raise ValueError(f"NCCL needs one device per rank, got {devs}")
    return devs


def _rank_entry(local_rank: int, fn, nprocs: int, args: tuple, devices, backend,
                timeout_s: float, workdir: str, pod) -> None:
    """Body of one spawned rank: join the mesh, run ``fn(mesh, *args)``,
    write its result for the parent and leave the process group."""
    dev = devices[local_rank]
    if dev.type == "cpu":
        torch.set_num_threads(1)
    if pod is None:
        mesh = make_mesh(nprocs, backend=backend, device=dev, rank=local_rank,
                         init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                         timeout_s=timeout_s)
    else:
        initialize_distributed(*pod, local_size=nprocs, local_rank=local_rank, device=dev,
                               backend=backend, timeout_s=timeout_s)
        mesh = make_mesh(backend=backend, device=dev, timeout_s=timeout_s)
    try:
        result = fn(mesh, *args)
        with open(os.path.join(workdir, f"result{local_rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        del result
        gc.collect()    # what fn dropped (loggers and their writer threads) ends here
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, args: tuple = (), *, device="cuda",
           backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
           join_timeout_s: Optional[float] = None, pod=None) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` spawned processes, one rank
    each, and return their results in local-rank order.

    ``fn`` is a module-level function (spawn pickles it by name; the child
    imports its module).  ``device`` "cuda" puts local rank r on
    ``cuda:r`` (NCCL; more ranks than visible GPUs raise before anything is
    spawned); "cpu" runs gloo; an indexed device with ``backend="gloo"``
    puts every rank on that one device.  ``pod`` (from :func:`pod_config`)
    joins a multi-host pod instead of a local rendezvous.  A rank that
    raises or exits non-zero ends the others and raises here; so does a
    join that outlasts ``join_timeout_s``.
    """
    devices = _local_devices(device, nprocs, backend)
    workdir = tempfile.mkdtemp(prefix="skyfall_ranks_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(fn, nprocs, args, devices, backend, timeout_s, workdir, pod),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
        while not ctx.join(timeout=None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"{nprocs} ranks did not finish within {join_timeout_s} s")
        results = []
        for r in range(nprocs):
            with open(os.path.join(workdir, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
