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

Under a train :func:`~repro_torch.parallel.sharding.mesh_context` every
rank runs the loop on its shards (``shardings=``: the state's tree of
``NamedSharding``): it feeds this rank's rows, restores and saves through
the shardings (rank 0 writes), and stops where rank 0 stops: rank 0's
SIGTERM/SIGINT decision is broadcast after every step, so a signal that
reaches one rank alone leaves no rank waiting in a collective. The
straggler monitor times this rank's own steps.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional

import torch.distributed as dist

from repro_torch.data.pipeline import batch_specs, shard_batch
from repro_torch.launch.mesh import AXES
from repro_torch.parallel.collectives import broadcast_ints
from repro_torch.parallel.sharding import active_ctx
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
        on_metrics: Optional[Callable[[int, dict], None]] = None,
        shardings: Any = None):
    """Run up to ``steps`` total steps, resuming from the latest checkpoint.

    ``data``: an object with ``batch_at(step) -> dict`` of numpy arrays
    (step-addressable); batches go to the device of ``state["step"]``.
    ``shardings``: the state's shardings, required under a train mesh
    (module docstring). Returns (state, history dict).
    """
    ctx = active_ctx()
    mesh = ctx.mesh if ctx is not None and ctx.mode == "train" else None
    if (mesh is None) != (shardings is None):
        raise ValueError("shardings= goes with a train mesh_context, and a "
                         "train mesh_context needs the state's shardings")
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    start_step = 0
    if ckpt_dir is not None:
        latest = ckpt_lib.find_latest(ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(ckpt_dir, state, step=latest,
                                     shardings=shardings)
            start_step = latest
            say(f"[loop] restored checkpoint step {latest}")
    device = state["step"].device

    def feed(step):
        batch = data.batch_at(step)
        if mesh is None:
            return shard_batch(batch, device=device)
        k = getattr(train_step, "grad_accum", 1)
        return shard_batch(batch, mesh=mesh, device=device, grad_accum=k,
                           specs=batch_specs(batch, ctx.rules, mesh, k))

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
            state, metrics = train_step(state, feed(step))
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if monitor.observe(step, dt):
                history["straggler_steps"].append(step)
                say(f"[loop] straggler at step {step}: {dt:.2f}s "
                      f"(ewma {monitor.ewma:.2f}s)")
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if on_metrics:
                on_metrics(step, {"loss": loss, "dt": dt})
            if log_every and step % log_every == 0:
                say(f"[loop] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt_lib.save(ckpt_dir, state, step + 1,
                                             async_=True,
                                             shardings=shardings)
            if mesh is not None:
                stop["now"] = bool(broadcast_ints([stop["now"]], mesh,
                                                  AXES)[0])
            if stop["now"]:
                say(f"[loop] signal received — checkpointing at step "
                    f"{step + 1}")
                break
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    if pending_save is not None:
        pending_save.join()
    if mesh is not None:
        dist.barrier(group=mesh.group)    # rank 0's files are in place
    if ckpt_dir and stop["now"]:
        ckpt_lib.save(ckpt_dir, state, step + 1, shardings=shardings)
    history["monitor"] = monitor.events
    return state, history
