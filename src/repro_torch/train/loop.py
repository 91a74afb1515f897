"""Fault-tolerant training loop. Port of ``repro/train/loop.py``.

* **checkpoint/restart**: periodic asynchronous checkpoints; on start the
  loop restores the newest checkpoint and replays the data stream from
  that step (the pipeline is step-addressable, so a restart is exact).
* **preemption safety**: SIGTERM/SIGINT stop the loop after the current
  step and save a checkpoint before it returns.
* **straggler monitor**: a per-step wall-time EWMA; steps slower than
  ``straggler_factor ×`` the EWMA are logged with their index.
* **metrics**: the loss and step-time history returned to the caller.

``float(loss)`` is each step's one host sync, so a step's wall time is
its device time plus whatever the host could not overlap.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional

from repro_torch.data.pipeline import shard_batch
from repro_torch.train import checkpoint as ckpt_lib


class StragglerMonitor:
    """Per-step wall-time EWMA with deadline flagging.

    The first ``warmup`` observations are left out of the estimate: the
    first steps pay one-time costs (kernel builds, allocator growth) that
    would otherwise poison the EWMA for dozens of steps.
    """

    def __init__(self, factor: float = 3.0, ewma: float = 0.9,
                 warmup: int = 2):
        self.factor = factor
        self.ewma_coef = ewma
        self.warmup = warmup
        self.seen = 0
        self.ewma: Optional[float] = None
        self.events: list = []

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.seen <= self.warmup:
            return False
        is_straggler = (self.ewma is not None
                        and dt > self.factor * self.ewma
                        and self.ewma > 0)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
        # stragglers don't poison the estimate
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = self.ewma_coef * self.ewma + (1 - self.ewma_coef) * dt
        return is_straggler


def run(train_step: Callable, state: Any, data, *, steps: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        log_every: int = 10, straggler_factor: float = 3.0,
        on_metrics: Optional[Callable[[int, dict], None]] = None):
    """Run up to ``steps`` total steps, resuming from the latest checkpoint.

    ``data``: an object with ``batch_at(step) -> dict`` of numpy arrays
    (step-addressable); batches go to the device of ``state["step"]``.
    Returns (state, history dict).
    """
    start_step = 0
    if ckpt_dir is not None:
        latest = ckpt_lib.find_latest(ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(ckpt_dir, state, step=latest)
            start_step = latest
            print(f"[loop] restored checkpoint step {latest}")
    device = state["step"].device

    monitor = StragglerMonitor(factor=straggler_factor)
    history = {"loss": [], "step_time": [], "straggler_steps": []}
    stop = {"now": False}

    def _sig(_s, _f):
        stop["now"] = True
    old_handlers = {s: signal.signal(s, _sig)
                    for s in (signal.SIGTERM, signal.SIGINT)}
    pending_save = None
    step = start_step
    try:
        for step in range(start_step, steps):
            t0 = time.time()
            batch = shard_batch(data.batch_at(step), device=device)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if monitor.observe(step, dt):
                history["straggler_steps"].append(step)
                print(f"[loop] straggler at step {step}: {dt:.2f}s "
                      f"(ewma {monitor.ewma:.2f}s)")
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if on_metrics:
                on_metrics(step, {"loss": loss, "dt": dt})
            if log_every and step % log_every == 0:
                print(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt_lib.save(ckpt_dir, state, step + 1,
                                             async_=True)
            if stop["now"]:
                print(f"[loop] signal received — checkpointing at step "
                      f"{step + 1}")
                break
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    if pending_save is not None:
        pending_save.join()
    if ckpt_dir and stop["now"]:
        ckpt_lib.save(ckpt_dir, state, step + 1)
    history["monitor"] = monitor.events
    return state, history
