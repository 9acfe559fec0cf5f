"""Metrics logging: JSONL + console (+ tensorboard when tensorboardX is
installed).

Port of ``skyfall_gs_tpu/train/logging.py``, writing the same records to
``<model_path>/metrics.jsonl``: ``step`` (every ``log_every`` iterations),
``densify`` and ``eval``; and ``trace``, the port's own: the totals of a
profiled window's spans and counters.  Step metrics arrive as device
tensors and are turned into host floats only at flush (every
``flush_every`` iterations), so a training step never waits on the device.
"""

from __future__ import annotations

import json
import os
import time
import weakref

import numpy as np


class MetricsLogger:
    def __init__(self, model_path: str, log_every: int = 10,
                 print_every: int = 200, flush_every: int = 200):
        self.model_path = model_path or "."
        self.log_every = log_every
        self.print_every = print_every
        self.flush_every = flush_every
        os.makedirs(self.model_path, exist_ok=True)
        self._jsonl = open(os.path.join(self.model_path, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(self.model_path)
        # Closes the files when the logger is collected, so that a spawned
        # rank that drops its Trainer stops tensorboardX's writer thread
        # before the process tears down its queues.
        self._finalizer = weakref.finalize(self, _release, self._jsonl, self._tb)
        self._ema_loss = 0.0
        self._t_last = time.time()
        self._step_last = 0
        self._pending = []  # (iteration, elapsed, device metrics)

    def log_step(self, iteration: int, metrics, elapsed: float) -> None:
        """Buffer device metrics; convert to host floats only at flush time
        so the training loop never blocks on a device sync per step."""
        if iteration % self.log_every != 0:
            return
        self._pending.append((iteration, elapsed, metrics))
        if iteration % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        for iteration, elapsed, metrics in self._pending:
            vals = {k: float(getattr(metrics, k)) for k in metrics._fields}
            self._ema_loss = 0.4 * vals["loss"] + 0.6 * self._ema_loss
            now = time.time()
            its = (iteration - self._step_last) / max(now - self._t_last, 1e-9)
            self._t_last, self._step_last = now, iteration
            rec = {"type": "step", "iter": iteration, "elapsed": elapsed,
                   "iters_per_sec": its, **vals}
            self._jsonl.write(json.dumps(rec) + "\n")
            if self._tb:
                for k, v in vals.items():
                    self._tb.add_scalar(f"train/{k}", v, iteration)
                self._tb.add_scalar("train/iters_per_sec", its, iteration)
            if vals.get("overflow", 0) > 0:
                print(f"[{iteration}] WARNING: binning capacity overflow — "
                      f"{int(vals['overflow'])} duplicated entries dropped "
                      "from the render and its gradients; raise "
                      "pipe.bin_capacity or let _update_bin_capacity re-run",
                      flush=True)
            if iteration % self.print_every == 0:
                print(f"[{iteration}] loss={self._ema_loss:.5f} "
                      f"psnr={vals['psnr']:.2f} n={int(vals['n_alive'])} "
                      f"{its:.2f} it/s", flush=True)
        self._pending.clear()
        self._jsonl.flush()

    def log_densify(self, iteration: int, stats) -> None:
        vals = {k: int(getattr(stats, k)) for k in stats._fields}
        rec = {"type": "densify", "iter": iteration, **vals}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb:
            self._tb.add_scalar("densify/total_points", vals["n_alive"], iteration)
        print(f"[densify @{iteration}] +{vals['n_cloned']} clone "
              f"+{vals['n_split']} split -{vals['n_pruned']} prune "
              f"(drop {vals['n_dropped']}) -> {vals['n_alive']}", flush=True)

    def log_eval(self, iteration: int, split: str, l1: float, psnr: float) -> None:
        rec = {"type": "eval", "iter": iteration, "split": split,
               "l1": l1, "psnr": psnr}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(f"{split}/l1", l1, iteration)
            self._tb.add_scalar(f"{split}/psnr", psnr, iteration)
        print(f"[eval @{iteration}] {split}: L1 {l1:.4f} PSNR {psnr:.2f}",
              flush=True)

    def log_trace(self, iteration: int, iterations: int, report: dict) -> None:
        """The spans and counters of a profiled window of ``iterations``
        iterations ending at ``iteration`` (``utils.trace.report``)."""
        rec = {"type": "trace", "iter": iteration, "iterations": iterations, **report}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, iteration: int, tag: str, image: np.ndarray) -> None:
        """(H, W, 3) float [0,1] host image to tensorboard (if available)."""
        if self._tb:
            self._tb.add_image(tag, np.clip(image, 0.0, 1.0).transpose(2, 0, 1), iteration)

    def log_histogram(self, iteration: int, tag: str, values: np.ndarray) -> None:
        if self._tb:
            self._tb.add_histogram(tag, values, iteration)

    def log_scalar(self, iteration: int, tag: str, value: float) -> None:
        if self._tb:
            self._tb.add_scalar(tag, value, iteration)

    def close(self) -> None:
        self.flush()
        self._finalizer()


def _release(jsonl, tb) -> None:
    jsonl.close()
    if tb:
        tb.close()
