"""Multi-pod dry run: rank 0's step of every (arch × shape × mesh) cell on
the meta device.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell's step for the production mesh and reads the compiler's memory and
cost analyses. There is no compiler to ask here, so the port runs rank
0's own step:

  1. joins a fake process group of the production world size (256 ranks
     on one pod, 512 on two) and takes rank 0's mesh
     (:func:`repro_torch.launch.mesh.fake_production_mesh`: (16, 16); on
     two pods (2, 16, 16) for the train rules, whose ``seq_act`` puts the
     sequence on ``pod``, and (32, 16) for the serve rules; each world
     size in a process of its own);
  2. builds rank 0's blocks of the params, optimizer state, caches and
     inputs on the ``meta`` device (shapes, no data), from the specs the
     port's sharded paths use (``slab_shards`` / ``shard_tree`` /
     ``init_serve_caches(mesh=, rules=)``);
  3. runs the real step (the train step under flat FSDP, the dense slab's
     prefill or decode step) under one dispatch mode (:class:`Counter`)
     that records the live storage bytes, the FLOPs and bytes of every
     aten op, each kernel's own FLOPs and bytes (the kernels' meta rules,
     :mod:`repro_torch.kernels.meta`: the card's kernel path, not the
     plain versions) and every collective's wire bytes;
  4. derives the three roofline terms on the H100's constants and writes
     one JSON record per cell.

The constants are the H100 SXM5's data sheet figures (the kernel table's
in ``PERF.md``): 989 TFLOP/s dense bf16 (every FLOP is divided by it, as
the reference divides by its bf16 peak), 3.35 TB/s HBM3, 450 GB/s a
direction of NVLink 4. A model axis of 16 spans two 8-card NVLink nodes,
so ``collective_s`` is a lower bound there. ``HBM_BYTES`` is the card's
``memory.total`` as ``nvidia-smi --query-gpu=name,power.limit,
memory.total`` reads it (``CARD``). Every number a record holds is a
prediction of a meta run on these constants, not a measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.shapes import SHAPES, runnable
from repro_torch.data.pipeline import RankBatch
from repro_torch.kernels import meta
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params, quantize_params
from repro_torch.optim.adamw import adamw
from repro_torch.parallel.sharding import (_block, axes_of, block_view,
                                           make_rules, mesh_context, named,
                                           shard_tree, spec_for,
                                           train_state_pspecs, tree_bytes)
from repro_torch.serving.engine import (build_decode_step,
                                        build_prefill_step,
                                        init_serve_caches, slab_context,
                                        slab_shards)
from repro_torch.train.train_step import build_train_step

# H100 SXM5 (per card)
PEAK_FLOPS = 989e12        # dense bf16 (int8: 1,979e12)
HBM_BW = 3.35e12           # B/s, HBM3
LINK_BW = 450e9            # B/s, NVLink 4, one direction
CARD = "NVIDIA H100 80GB HBM3, 700.00 W, 81559 MiB"
HBM_BYTES = 81559 * 2**20

BIG_PARAM_THRESHOLD = 20e9   # int8 optimizer moments above this

# ---------------------------------------------------------------------------
# Input and state specs
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, batch: int, seq: int, rules, mesh):
    """(whole meta inputs and labels, their specs) of a train batch: the
    multi-pod train rules put its sequence (``seq_act``) on ``pod``."""
    if cfg.embedding_inputs:
        inp = torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
        inp_spec = spec_for(inp.shape, ("batch", "seq_act", None), rules,
                            mesh)
    else:
        inp = torch.empty((batch, seq), dtype=torch.int32, device="meta")
        inp_spec = spec_for(inp.shape, ("batch", "seq_act"), rules, mesh)
    lab = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    lab_spec = spec_for(lab.shape, ("batch", "seq_act"), rules, mesh)
    return {"inputs": inp, "labels": lab}, {"inputs": inp_spec,
                                            "labels": lab_spec}


def serve_cfg(cfg: ModelConfig, kind: str) -> ModelConfig:
    """Per-kind config tweaks (q-chunked exact attention for long
    prefill), the reference's."""
    if kind == "prefill":
        chunk = 4096 if (cfg.n_heads == 0 or cfg.n_heads % 16 == 0) else 512
        return dataclasses.replace(cfg, attn_q_chunk=chunk, remat=True)
    if kind == "train":
        return dataclasses.replace(cfg, attn_q_chunk=1024)
    return cfg


def _meta_params(cfg: ModelConfig) -> dict:
    return init_params(cfg, generator=torch.Generator(), device="meta")


def _rows(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """Rank 0's block of a whole meta input, its own storage."""
    return block_view(x, spec, mesh).clone(
        memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Cell builders: return (run, args); run(*args) is the step in its context
# ---------------------------------------------------------------------------
def build_train_cell(cfg: ModelConfig, shape, mesh, rules):
    """Rank 0's flat-FSDP train step: its blocks of the state and of the
    global batch's rows."""
    cfg = serve_cfg(cfg, "train")
    quant_moments = cfg.param_count() > BIG_PARAM_THRESHOLD
    opt = adamw(lr=1e-4, quantize_moments=quant_moments)
    step_fn = build_train_step(cfg, opt)
    params = _meta_params(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    state = shard_tree(state, named(train_state_pspecs(state, rules, mesh),
                                    mesh))
    whole, specs = batch_specs(cfg, shape.global_batch, shape.seq_len,
                               rules, mesh)
    axes, seq_axes = (axes_of(e) for e in specs["labels"])
    seq_idx, seq_n = _block(seq_axes, mesh.coords, mesh)
    shards = math.prod(mesh.shape[a] for a in axes + seq_axes)
    batch = RankBatch({k: _rows(v, specs[k], mesh) for k, v in whole.items()},
                      axes, shards, seq_axes=seq_axes,
                      start=seq_idx * shape.seq_len // seq_n)

    def run(state, batch):
        with mesh_context(mesh, rules, mode="train"):
            return step_fn(state, batch)
    return run, (state, batch)


def _serve_params(cfg: ModelConfig, qmode: str, mesh, rules):
    """Rank 0's shards of the quantized params for the dense slab under
    ``rules``."""
    return slab_shards(quantize_params(_meta_params(cfg), cfg, qmode),
                       mesh, cfg, rules)


def build_prefill_cell(cfg: ModelConfig, shape, mesh, rules, qmode: str):
    cfg = serve_cfg(cfg, "prefill")
    step = build_prefill_step(cfg)
    params = _serve_params(cfg, qmode, mesh, rules)
    caches = init_serve_caches(cfg, shape.global_batch, shape.seq_len,
                               device="meta", mesh=mesh, rules=rules)
    if cfg.embedding_inputs:
        inp = torch.empty((shape.global_batch, shape.seq_len, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
        spec = spec_for(inp.shape, ("batch", "seq_act", None), rules, mesh)
    else:
        inp = torch.empty((shape.global_batch, shape.seq_len),
                          dtype=torch.int32, device="meta")
        spec = spec_for(inp.shape, ("batch", "seq_act"), rules, mesh)

    def run(params, inputs, caches):
        with slab_context(mesh, params.layout, rules):
            return step(params, inputs, caches)
    return run, (params, _rows(inp, spec, mesh), caches)


def build_decode_cell(cfg: ModelConfig, shape, mesh, rules, qmode: str,
                      kv_dtype=None):
    """Rank 0's decode step at the slab's last position (the host int
    ``pos`` is no device argument here)."""
    cfg = serve_cfg(cfg, "decode")
    step = build_decode_step(cfg)
    params = _serve_params(cfg, qmode, mesh, rules)
    caches = init_serve_caches(cfg, shape.global_batch, shape.seq_len,
                               kv_dtype=kv_dtype, device="meta", mesh=mesh,
                               rules=rules)
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                      device="meta")
    spec = spec_for(tok.shape, ("batch", None), rules, mesh)
    pos = shape.seq_len - 1

    def run(params, caches, token):
        with slab_context(mesh, params.layout, rules):
            return step(params, caches, token, pos)
    return run, (params, caches, _rows(tok, spec, mesh))


# ---------------------------------------------------------------------------
# The counter: live bytes, FLOPs, bytes accessed, collectives
# ---------------------------------------------------------------------------
# ring wire bytes per device, R the result bytes, n the group (the
# reference's ``parse_collectives``); c10d op → the reference's kind
_C10D_KINDS = {"allreduce_": "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "allgather_into_tensor_coalesced_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
               "broadcast_": "collective-permute",
               "send": "collective-permute", "recv_": "collective-permute"}
# allocation only: no byte moves
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias"}


def wire_bytes(kind: str, r_bytes: float, n: int) -> float:
    """One collective's wire bytes a device on a ring of ``n``: R the
    gathered block (all-gather), the reduced block (all-reduce), the
    scattered shard (reduce-scatter), the received block (all-to-all)."""
    if kind == "all-gather":
        return r_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * r_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return r_bytes * (n - 1)
    if kind == "all-to-all":
        return r_bytes * (n - 1) / n
    return r_bytes                       # collective-permute


def _tensors_of(x, out: list) -> list:
    """The tensors of a tree (nested lists, tuples, dict values and
    dataclass fields: an op's arguments or results, a step's arguments
    with their QuantizedTensors and caches) appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors_of(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors_of(y, out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _tensors_of(getattr(x, f.name), out)
    return out


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors_of(x, []))


# What the card holds that no dispatch mode sees (measured on the H100,
# torch 2.11: ``chip_smoke.py`` phase 16's cells, op by op):
# * PyTorch's cuBLAS workspace, 32 MiB a thread that runs a float GEMM
#   (the step's thread, and autograd's device thread in a backward), kept
#   for the process's life;
# * transient bytes a kernel allocates inside one op: a sum over dims of a
#   bool or 16-bit float tensor stages numel × 8 bytes; the softmax
#   backward of a non-contiguous gradient copies it twice.
CUBLAS_WORKSPACE_BYTES = 32 * 2**20
# where those rules were checked against the card; every other cell
# applies them unchecked
CARD_TERMS_CHECKED = ("chip_smoke.py phase 16: qwen2-0.5b x decode_32k "
                      "and qwen3-0.6b x train_4k, torch 2.11")
_FLOAT_GEMMS = {"mm", "bmm", "addmm", "baddbmm", "addmv", "mv"}
_STAGED_SUMS = (torch.bool, torch.bfloat16, torch.float16)


def kernel_temp_bytes(func, args) -> int:
    """The transient bytes the card's kernel of ``func`` allocates inside
    the op, beside its inputs and outputs (the rules above)."""
    name = func._overloadpacket.__name__
    if (func is torch.ops.aten.sum.dim_IntList
            and args[0].dtype in _STAGED_SUMS):
        return args[0].numel() * 8
    if name == "_softmax_backward_data" and not args[0].is_contiguous():
        return 2 * args[0].numel() * args[0].element_size()
    return 0


class Counter(TorchDispatchMode):
    """One dispatch mode over a step: every storage made inside it (keyed
    by ``untyped_storage()._cdata``, released when its last view dies, by
    a ``weakref.finalize``; not a view's, not one of ``known``, the
    arguments') counts toward the live bytes and their peak;
    every aten op adds its FLOPs (``torch.utils.flop_counter``'s formulas)
    and its inputs' and outputs' bytes (views and allocations move none);
    the kernels' meta rules add their own (:mod:`repro_torch.kernels.
    meta`); each collective adds its count, result bytes and ring wire
    bytes by kind (:func:`wire_bytes`). ``peak_card`` adds to the live
    bytes what the card holds beside them: an op's kernel temporaries
    while it runs (:func:`kernel_temp_bytes`); ``gemm_threads`` are the
    threads that ran a float GEMM (one cuBLAS workspace each)."""

    def __init__(self, known=()):
        super().__init__()
        self.known = set(known)       # storages made before (arguments)
        self.live: dict = {}
        self.cur = self.peak = self.peak_card = 0
        self.gemm_threads: set = set()
        self.flops = self.bytes = 0.0
        self.ops = 0
        self._rules: dict = {}
        self.kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0,
                                            "bytes": 0.0})
        self.collectives = defaultdict(lambda: {"count": 0,
                                                "result_bytes": 0,
                                                "wire_bytes": 0})

    def __enter__(self):
        self._rec = meta.recording(self.kernel)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(*exc)

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        k = self.kernels[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.flops += flops
        self.bytes += n_bytes

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def track(self, out) -> None:
        """Count the storages of ``out`` not seen yet."""
        for t in _tensors_of(out, []):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self.known:
                continue
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            self.peak = max(self.peak, self.cur)
            self.peak_card = max(self.peak_card, self.cur)
            weakref.finalize(st, self._free, key)

    def _collective(self, func, args, out) -> None:
        kind = _C10D_KINDS.get(func._overloadpacket.__name__)
        if kind is None:
            raise NotImplementedError(f"dry run: no wire rule for {func}")
        pg = next(a for a in args if type(a).__name__ == "ScriptObject")
        n = torch.distributed.ProcessGroup.unbox(pg).size()
        names = [a.name for a in func._schema.arguments]
        # the result: the gathered / scattered / exchanged outputs, or the
        # all-reduced (broadcast) tensors themselves
        key = ("output_tensors" if "output_tensors" in names else
               "output" if "output" in names else "tensors")
        r_bytes = _bytes(args[names.index(key)])
        if n <= 1:
            return
        s = self.collectives[kind]
        s["count"] += 1
        s["result_bytes"] += r_bytes
        s["wire_bytes"] += int(wire_bytes(kind, r_bytes, n))

    def _rule(self, func):
        """(does ``func`` move bytes, its FLOP formula or None), once an
        op."""
        rule = self._rules.get(func)
        if rule is None:
            name = func._overloadpacket.__name__
            rule = self._rules[func] = (
                not func.is_view and name not in _NO_TRAFFIC,
                flop_registry.get(func._overloadpacket))
        return rule

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.namespace == "c10d":
            self._collective(func, args, out)
        else:
            moves, count = self._rule(func)
            if moves:
                self.bytes += _bytes(args) + _bytes(kwargs) + _bytes(out)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            if func._overloadpacket.__name__ in _FLOAT_GEMMS and \
                    args[0].is_floating_point():
                # autograd runs a card's backward on a thread of its own
                self.gemm_threads.add(
                    torch._C._current_graph_task_id() >= 0)
        if not func.is_view:          # a view's storage is its base's
            self.track(out)
            temp = kernel_temp_bytes(func, args)
            if temp:
                self.peak_card = max(self.peak_card, self.cur + temp)
        return out


def measure(run, args) -> dict:
    """Run ``run(*args)`` on meta under a :class:`Counter`: the memory
    (arguments, outputs new and aliasing arguments, the temporaries at the
    peak with the card's named terms: the kernels' own temporaries at the
    peak and the cuBLAS workspaces), the cost, the collectives and the
    kernels."""
    arg_keys = {t.untyped_storage()._cdata for t in _tensors_of(args, [])}
    arg_bytes = tree_bytes(list(args))
    t0 = time.perf_counter()
    with Counter(arg_keys) as c:
        out = run(*args)
    run_s = time.perf_counter() - t0
    out_new = alias = 0
    seen = set()
    for t in _tensors_of(out, []):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        if st._cdata in arg_keys:
            alias += st.nbytes()
        else:
            out_new += st.nbytes()
    del out
    workspace = CUBLAS_WORKSPACE_BYTES * len(c.gemm_threads)
    kernel_temps = c.peak_card - c.peak
    peak = arg_bytes + c.peak_card + workspace
    return {
        "run_s": round(run_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_new + alias,
            "temp_bytes": c.peak_card + workspace - out_new,
            "alias_bytes": alias,
            "peak_bytes": peak,
            "fits_80g": peak < HBM_BYTES,
            # the card's terms inside temp_bytes, which the meta run
            # cannot see (the rules above ``Counter``)
            "terms": {"live_peak_bytes": c.peak,
                      "kernel_temp_bytes": kernel_temps,
                      "cublas_workspace_bytes": workspace},
        },
        "cost": {"flops": c.flops, "bytes accessed": c.bytes},
        "collectives": {k: dict(v) for k, v in c.collectives.items()},
        "kernels": {k: dict(v) for k, v in c.kernels.items()},
        "aten_ops": c.ops,
    }


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape) -> float:
    """Global MODEL_FLOPS per step: 6·N_active·tokens (train) /
    2·N_active·tokens (serve)."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch          # decode: 1 token/seq


def roofline(record: dict, n_devices: int, cfg: ModelConfig, shape) -> dict:
    flops = record["cost"].get("flops", 0.0)
    bytes_acc = record["cost"].get("bytes accessed", 0.0)
    wire = sum(s["wire_bytes"] for s in record["collectives"].values())
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    collective_s = wire / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape) / n_devices
    return {
        **terms,
        "bottleneck": bottleneck,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": (mf / flops) if flops else 0.0,
        "roofline_frac": (mf / PEAK_FLOPS) / max(compute_s, memory_s,
                                                 collective_s, 1e-30),
        "wire_bytes": wire,
    }


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------
def build_cell(cfg: ModelConfig, shape, mesh, rules, qmode: str,
               kv_dtype=None):
    """(run, args) of a cell's step for rank 0 of ``mesh``."""
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, rules)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, rules, qmode)
    return build_decode_cell(cfg, shape, mesh, rules, qmode, kv_dtype)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             qmode: str = "none", kv_dtype=None, rules_override=None,
             cfg_override=None, verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch, qmode=qmode)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    mesh = fake_production_mesh(multi_pod, train=shape.kind == "train")
    n_dev = math.prod(mesh.shape.values())
    rules = make_rules(mode=shape.kind, multi_pod=multi_pod,
                       family=cfg.family)
    if rules_override:
        rules.update(rules_override)

    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "qmode": qmode, "kv_dtype": kv_dtype,
        "n_devices": n_dev,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "card": CARD,
        "torch": torch.__version__,
        "card_terms_checked": CARD_TERMS_CHECKED,
    }
    if not runnable(cfg.family, shape):
        rec["status"] = "SKIP(sub-quadratic-only)"
        return rec

    try:
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad():
            run, args = build_cell(cfg, shape, mesh, rules, qmode, kv_dtype)
            rec.update(measure(run, args))
    except Exception as exc:  # noqa: BLE001 — a failed cell is a recorded bug
        rec["status"] = "FAIL"
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        return rec
    rec["status"] = "OK"
    rec["roofline"] = roofline(rec, n_dev, cfg, shape)
    if verbose:
        m = rec["memory"]
        r = rec["roofline"]
        print(f"  mem/device: args={m['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
              f"peak={m['peak_bytes'] / 2**30:.2f}GiB "
              f"fits80G={m['fits_80g']}")
        print(f"  roofline: compute={r['compute_s'] * 1e3:.2f}ms "
              f"memory={r['memory_s'] * 1e3:.2f}ms "
              f"collective={r['collective_s'] * 1e3:.2f}ms "
              f"→ {r['bottleneck']} | useful={r['useful_flops_ratio']:.2f} "
              f"frac={r['roofline_frac']:.3f} | run {rec['run_s']} s")
    return rec


def cell_id(arch, shape, multi_pod, qmode, kv_dtype=None, tag=""):
    mesh = "multi" if multi_pod else "single"
    kv = f"__kv{kv_dtype}" if kv_dtype else ""
    t = f"__{tag}" if tag else ""
    return f"{arch}__{shape}__{mesh}__{qmode}{kv}{t}"


def _mesh_cells(cells, out: str, force: bool, kv_dtype):
    """Run one mesh shape's cells in this process (a spawned one: the
    fake process group is global to it) → their records."""
    results = []
    for arch, shape_name, multi_pod, qmode in cells:
        cid = cell_id(arch, shape_name, multi_pod, qmode, kv_dtype)
        path = Path(out) / f"{cid}.json"
        if path.exists() and not force:
            print(f"[cached] {cid}", flush=True)
            results.append(json.loads(path.read_text()))
            continue
        print(f"[run] {cid}", flush=True)
        rec = run_cell(arch, shape_name, multi_pod=multi_pod, qmode=qmode,
                       kv_dtype=kv_dtype)
        path.write_text(json.dumps(rec, indent=1, default=float))
        print(f"  -> {rec['status']}"
              + (f" ({rec.get('error', '')})" if rec["status"] == "FAIL"
                 else ""), flush=True)
        results.append(rec)
    return results


def table(records) -> str:
    """A markdown table of the OK records: GB a rank at the peak, whether
    it fits, the three roofline terms (ms) and the bottleneck."""
    rows = ["| arch | shape | mesh | GB a rank | fits 80 GB | compute ms | "
            "memory ms | collective ms | bottleneck |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["status"] != "OK":
            continue
        m, f = r["memory"], r["roofline"]
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                    f"{m['peak_bytes'] / 1e9:.2f} | {m['fits_80g']} | "
                    f"{f['compute_s'] * 1e3:.2f} | {f['memory_s'] * 1e3:.2f} "
                    f"| {f['collective_s'] * 1e3:.2f} | {f['bottleneck']} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--qmode", default=None,
                    help="override serve qmode (default: none for train, "
                         "w8a8 for serve)")
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    Path(args.out).mkdir(parents=True, exist_ok=True)
    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    t0 = time.perf_counter()
    results = []
    ctx = multiprocessing.get_context("spawn")
    for multi_pod in meshes:
        cells = []
        for arch in archs:
            for shape_name in shapes:
                kind = SHAPES[shape_name].kind
                qmodes = ([args.qmode] if args.qmode is not None
                          else ["none"] if kind == "train" else ["w8a8"])
                cells += [(arch, shape_name, multi_pod, q) for q in qmodes]
        with ctx.Pool(1) as pool:       # a process a mesh shape
            results += pool.apply(_mesh_cells, (cells, args.out, args.force,
                                                args.kv_dtype))

    print(table(results))
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"].startswith("SKIP") for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n=== dry-run summary: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells in {time.perf_counter() - t0:.1f} s ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
