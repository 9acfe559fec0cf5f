"""Scene-parallel launcher: one training job per scene across workers.

Port of ``skyfall_gs_tpu/parallel/launcher.py`` (reference
scripts/run_jax.py:52-87, scripts/run_nyc_idu.py:24-112,
render_videos.py:115-176): embarrassingly parallel per-scene job dispatch
with per-scene logs and fault isolation (a failed scene does not stop the
batch).

Workers are "slots": each job takes its slot's environment from
``slot_envs``, which is how a job gets its GPU
(``{"CUDA_VISIBLE_DEVICES": "i"}``).  With one slot it is a serial queue
with logging.  The jobs' commands point at the port's CLIs.
"""

from __future__ import annotations

import os
import queue
import shlex
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class SceneJob:
    name: str
    argv: List[str]
    env: Dict[str, str] = field(default_factory=dict)
    returncode: Optional[int] = None
    log_path: str = ""


def run_scene_jobs(
    jobs: Sequence[SceneJob],
    log_dir: str,
    num_workers: int = 1,
    slot_envs: Optional[List[Dict[str, str]]] = None,
) -> List[SceneJob]:
    """Run jobs with ``num_workers`` concurrent slots; each job's output goes
    to ``<log_dir>/<name>.log``.  A command that cannot start gets return
    code 127 and its error in the log."""
    os.makedirs(log_dir, exist_ok=True)
    q: queue.Queue = queue.Queue()
    for j in jobs:
        q.put(j)

    def worker(slot: int):
        while True:
            try:
                job: SceneJob = q.get_nowait()
            except queue.Empty:
                return
            env = dict(os.environ)
            if slot_envs and slot < len(slot_envs):
                env.update(slot_envs[slot])
            env.update(job.env)
            job.log_path = os.path.join(log_dir, f"{job.name}.log")
            t0 = time.time()
            print(f"[launcher] slot {slot}: {job.name}: "
                  f"{' '.join(shlex.quote(a) for a in job.argv)}", flush=True)
            with open(job.log_path, "w") as lf:
                try:
                    proc = subprocess.Popen(job.argv, stdout=lf, stderr=lf, env=env)
                except OSError as e:
                    lf.write(f"[launcher] could not start: {e}\n")
                    job.returncode = 127
                else:
                    job.returncode = proc.wait()
            status = "ok" if job.returncode == 0 else f"FAILED ({job.returncode})"
            print(f"[launcher] {job.name}: {status} in {time.time() - t0:.0f}s",
                  flush=True)
            q.task_done()

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range(num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [j.name for j in jobs if j.returncode != 0]
    if failed:
        print(f"[launcher] failed scenes: {failed}", flush=True)
    return list(jobs)


def make_training_jobs(
    scenes: Sequence[str],
    data_root: str,
    output_root: str,
    extra_args: Sequence[str] = (),
    idu: bool = False,
    python: str = "python",
) -> List[SceneJob]:
    """Canonical per-scene training commands (reference scripts/run_jax.py),
    running ``skyfall_gs_tpu_torch.cli.train``; ``python`` is the
    interpreter the jobs start (``sys.executable`` for this one)."""
    jobs = []
    for scene in scenes:
        argv = [python, "-m", "skyfall_gs_tpu_torch.cli.train",
                "-s", os.path.join(data_root, scene),
                "-m", os.path.join(output_root, scene)]
        argv += list(extra_args)
        if idu:
            argv += ["--iterative_datasets_update",
                     "--start_checkpoint",
                     os.path.join(output_root, scene, "chkpnt30000.npz")]
        jobs.append(SceneJob(name=scene, argv=argv))
    return jobs
