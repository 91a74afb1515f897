"""Meshes of ranks: one process a rank.

Port of ``repro/launch/mesh.py``. The reference builds a (data, model)
device mesh under one controller; here every rank is a process of its own,
joined to the others through ``torch.distributed``:

* :func:`init_rank` joins the process group with an explicit backend and
  ``init_method`` (nothing on the machine announces a cluster);
* :func:`make_mesh` returns this rank's :class:`RankMesh` of a (pod,
  data, model) shape (the counterpart of ``make_test_mesh(shape,
  axes)``; a (data, model) shape has one pod): its coordinates, its rank
  row-major over them, and a process subgroup over each set of axes (its
  row of the model axis, its column of the data axis, its pod pair, the
  ranks of its (pod, data) plane ...); a serving mesh of ``tp`` ranks is
  ``make_mesh((1, tp))``;
* :func:`spawn_ranks` starts the rank processes (the ``spawn`` start
  method), runs a function in each and returns their results, failing
  loudly on any error or past its timeout;
* :func:`fake_production_mesh` is rank 0's view of the production mesh
  (the reference's ``make_production_mesh``) in a process of its own,
  under a fake process group of the production world size: collectives
  take tensors and move nothing (the dry run, :mod:`repro_torch.launch.
  dryrun`).

Backends: NCCL where each rank has a card of its own; gloo on the CPU, or
on one card shared by several ranks when the caller asks for it (NCCL
refuses two ranks on one device). Like every entry point, a mesh needs the
card unless the caller asks for the CPU (:mod:`repro_torch.device`).
"""
from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device


def pick_backend(world: int, device: torch.device,
                 backend: Optional[str] = None) -> str:
    """The process group's backend for ``world`` ranks on ``device``.

    Default: NCCL on a card, gloo on the CPU. NCCL needs a card a rank:
    with fewer cards than ranks it raises ``ValueError`` (ask for gloo to
    share one card)."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        n = torch.cuda.device_count()
        if n < world:
            raise ValueError(
                f"nccl needs a card a rank: {world} ranks, {n} card(s); "
                "pass backend='gloo' to share a card between ranks")
    return backend


def init_rank(rank: int, world: int, *, init_method: str,
              backend: Optional[str] = None, device=None) -> torch.device:
    """Join the process group as ``rank`` of ``world``; returns this rank's
    device. ``init_method``: ``file://<path>`` (a path all ranks share) or
    ``tcp://localhost:<port>``."""
    device = resolve_device(device)
    backend = pick_backend(world, device, backend)
    if device.type == "cuda" and backend == "nccl":
        device = torch.device("cuda", rank)      # a card a rank
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return device


AXES = ("pod", "data", "model")


def axis_sizes(shape) -> dict:
    """``(d, m)``, ``(p, d, m)`` or a dict of axis sizes → a size for each
    of :data:`AXES` (an axis left out is 1)."""
    if not isinstance(shape, dict):
        shape = tuple(shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"mesh shape {shape}: (d, m) or (p, d, m)")
        shape = dict(zip(AXES[3 - len(shape):], shape))
    unknown = set(shape) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}: of {AXES}")
    return {a: int(shape.get(a, 1)) for a in AXES}


def _live(axes, shape) -> tuple:
    """The axes of ``axes`` longer than one, in mesh order."""
    return tuple(a for a in AXES if a in axes and shape[a] > 1)


class RankMesh:
    """This rank's view of a (pod, data, model) mesh of ranks.

    ``shape``: ``{"pod": p, "data": d, "model": m}`` (an axis left out of
    the given shape is 1); ``rank``: this rank's index in ``group`` (all
    the mesh's ranks), row-major over the coordinates, ``(pod · d + data)
    · m + model``; ``groups``: for each set of axes longer than one that
    is not all of them, the subgroup of the ranks that differ from this
    one only along those axes, its members row-major over their
    coordinates. A single axis's group is keyed by its name, a set by the
    tuple of its names in mesh order.
    """

    def __init__(self, shape: dict, rank: int, group, groups: dict,
                 device: torch.device):
        self.shape = axis_sizes(shape)
        self.rank = rank
        coords, r = {}, rank
        for a in reversed(AXES):
            r, coords[a] = divmod(r, self.shape[a])
        self.coords = {a: coords[a] for a in AXES}
        self.group = group
        self.groups = dict(groups)
        self.device = device

    def group_of(self, axes):
        """The subgroup over ``axes`` (longer-than-one axes only): None if
        none is left, the whole mesh's group if every such axis is in."""
        live = _live(axes, self.shape)
        if not live:
            return None
        if live == _live(AXES, self.shape):
            return self.group
        return self.groups[live[0] if len(live) == 1 else live]

    def member_coords(self, axes, j: int) -> dict:
        """The coordinates of member ``j`` of :meth:`group_of` ``(axes)``:
        this rank's, with the group's axes taken row-major from ``j``."""
        coords = dict(self.coords)
        for a in reversed(_live(axes, self.shape)):
            j, coords[a] = divmod(j, self.shape[a])
        return coords

    def __repr__(self):
        return (f"{type(self).__name__}({self.shape}, rank {self.rank}, "
                f"{dist.get_backend(self.group)} on {self.device})")


def _subsets(live: tuple) -> list:
    """Every set of the ``live`` axes but the empty one and all of them,
    in one order (single axes first)."""
    return [c for size in range(1, len(live))
            for c in itertools.combinations(live, size)]


def make_mesh(shape, *, device=None) -> RankMesh:
    """This rank's (pod, data, model) mesh over the joined process group
    (call :func:`init_rank` first); ``shape``: ``(d, m)``, ``(p, d, m)``
    or a dict of axis sizes, p·d·m the world size. Every rank creates
    every subgroup, in one order (``dist.new_group`` must be called so)."""
    if not dist.is_initialized():
        raise RuntimeError("join the process group first (init_rank)")
    shape = axis_sizes(shape)
    size = math.prod(shape.values())
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a {tuple(shape.values())} mesh needs {size} "
                         f"ranks, not {world}")
    rank = dist.get_rank()
    coords = [RankMesh(shape, r, None, {}, None).coords for r in range(size)]
    groups = {}
    for axes in _subsets(_live(AXES, shape)):
        rest = [a for a in AXES if a not in axes]
        members = {}         # the coordinates off ``axes`` → the ranks
        for r, c in enumerate(coords):
            members.setdefault(tuple(c[a] for a in rest), []).append(r)
        for key, ranks in members.items():
            grp = dist.new_group(ranks)
            if key == tuple(coords[rank][a] for a in rest):
                groups[axes[0] if len(axes) == 1 else axes] = grp
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return RankMesh(shape, rank, dist.group.WORLD, groups, device)


def _to_host(x):
    """Tensors in a rank's result → numpy (bf16 as f32): a tensor would
    travel through shared memory that dies with the rank."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, world, init_method, backend, device, args,
               results, shape) -> None:
    try:
        if backend == "gloo":       # the ranks share this host: loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = init_rank(rank, world, init_method=init_method,
                        backend=backend, device=device)
        mesh = make_mesh(shape or (1, world), device=dev)
        results.put((rank, "ok", _to_host(fn(mesh, *args))))
    except BaseException:          # reported to the parent, then re-raised
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], world: int, *, init_dir: str,
                backend: Optional[str] = None, device=None,
                args: Sequence[Any] = (), timeout: Optional[float] = None,
                shape=None) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` rank processes → the results
    in rank order (their tensors as numpy arrays). ``mesh`` is this rank's
    :func:`make_mesh` of ``shape`` ((d, m) or (p, d, m)), by default (1,
    ``world``): the serving mesh, every rank on the model axis.

    ``fn`` and ``args`` are pickled (``fn`` by its import path); each rank
    joins through a file under ``init_dir`` (a fresh directory of the
    caller's), with ``backend`` as :func:`pick_backend` decides. Raises
    ``RuntimeError`` with every failing rank's traceback, and
    ``TimeoutError`` (after killing the ranks) when ``timeout`` seconds
    (None: no limit) pass first.
    """
    device = resolve_device(device)
    backend = pick_backend(world, device, backend)
    init_method = "file://" + os.path.join(os.path.abspath(init_dir),
                                           "rendezvous")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init_method, backend, str(device),
                               tuple(args), results, shape), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (timeout if timeout is not None
                                   else float("inf"))
    got, errors = {}, {}
    try:
        while len(got) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, out = results.get(timeout=min(max(left, 0.1),
                                                            1.0))
            except queue_mod.Empty:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world - len(got) - len(errors)} of {world} ranks "
                        f"gave no result within {timeout:.0f} s") from None
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead and results.empty():
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                continue
            (got if status == "ok" else errors)[rank] = out
            if errors:
                break          # the others may wait on the failed rank
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 1.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("rank failure:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items())))
    return [got[r] for r in range(world)]


def production_shape(multi_pod: bool = False, train: bool = False
                     ) -> tuple:
    """The shape of the production mesh: (16, 16) (data, model) on one
    pod. On two, the train rules' (2, 16, 16) (pod, data, model): their
    ``seq_act`` takes the pod axis alone. The serve, prefill and decode
    rules bind ``pod`` only together with ``data``
    (``parallel.sharding.make_rules``), so their cells take (32, 16),
    whose rank blocks are the reference's on (2, 16, 16)."""
    if not multi_pod:
        return (16, 16)
    return (2, 16, 16) if train else (32, 16)


def fake_production_mesh(multi_pod: bool = False, *, train: bool = False,
                         device="meta") -> RankMesh:
    """Rank 0's :class:`RankMesh` of :func:`production_shape` under a fake
    process group (``torch.testing._internal.distributed.fake_pg``) of its
    world size, joined here unless this process has joined it already:
    every collective takes tensors of any device and moves nothing. The
    process group is global to a process, so each world size runs in a
    process of its own (a joined group of another size raises)."""
    shape = production_shape(multi_pod, train)
    world = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif (dist.get_backend() != "fake"
          or dist.get_world_size() != world):
        raise RuntimeError(
            f"this process joined a {dist.get_backend()} group of "
            f"{dist.get_world_size()} ranks; the {shape} mesh needs a fake "
            "one of its own (run each world size in a process of its own)")
    if shape not in _FAKE:       # the subgroups, made once a process
        _FAKE[shape] = make_mesh(shape, device="cpu")
    mesh = _FAKE[shape]
    return RankMesh(mesh.shape, mesh.rank, mesh.group, mesh.groups,
                    resolve_device(device))


_FAKE: dict = {}

