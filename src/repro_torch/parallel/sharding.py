"""Divisibility-aware logical-axis sharding rules, and one rank's shards.

Port of ``repro/parallel/sharding.py``. A spec is a tuple with one entry a
dim: None (replicated), a mesh axis name, or a tuple of axis names (a joint
binding); the reference's ``PartitionSpec`` holds the same entries. The
rule tables and the spec resolution are the reference's, as data.

The reference runs one controller over a device mesh and lets ``shard_map``
and GSPMD place the shards. Here each rank is a process of its own
(:mod:`repro_torch.launch.mesh`): :func:`mesh_context` makes a mesh active
for the model code of this rank, exactly as the reference's context does
(``serve_tp`` and ``effective_model_shards`` answer the same), and
:func:`shard_params` cuts this rank's shards out of a full params tree by
the specs :func:`params_pspecs` gives.

The reference's ``logical`` (a GSPMD layout hint on an activation) has no
eager counterpart and is not ported: a rank's tensors are its own shards.

Which weights a rank holds as shards is decided once, by
:func:`serve_pspecs`, for the path that runs the shards
(:func:`for_dense_slab`: attention the model axis does not divide is
whole on the paged engine, column blocks on the dense slab);
:func:`shard_params` records the decision as the tree's ``layout`` (a set
of :data:`PARTS`), the serving :func:`mesh_context` carries it, and the
model code asks :func:`sharded`.

Two serving modes run on shards, and the model code tells them apart:

* ``mode="serve"``, the paged engine's, the reference's explicit
  ``shard_map`` tensor parallelism: a row-parallel projection quantizes
  its input from the rank's own K shard (``modules.row_parallel_linear``);
* ``mode="dense"``, the dense slab's (``build_prefill_step`` /
  ``build_decode_step`` and ``generate(mesh=)``), where the reference
  runs plain model code on sharded operands and GSPMD keeps the one-
  process meaning: a row-parallel projection takes the whole row's
  activation scale (``modules.whole_row_linear``), and the rules in the
  context decide the rest. Under ``make_rules("serve")`` the rows stay
  whole on every rank; under ``make_rules("prefill" | "decode")`` a
  (data, model) mesh splits the batch over data (:func:`data_split`), the
  KV slab over model by kv heads or else by positions
  (:func:`cache_pspecs`, ``serving.kv_cache.DenseKVCache.start``), and
  the MoE dispatch slab by expert over data (``models.moe``).

Training (flat FSDP under ``make_rules("train")``) keeps every leaf of the
train state as this rank's block along every sharded dim, on the data and
model axes (the multi-pod rules bind no weight to ``pod``: a block is a
replica there, and the pod axis splits the batch's sequence instead):
:func:`train_state_pspecs` gives the specs of a whole state,
:class:`NamedSharding` pairs a spec with its mesh (as the reference's), and
:func:`shard_tree` / :func:`gather_tree` cut a whole tree into this rank's
shards and make shards whole again (the checkpoints; the step gathers one
layer at a time, :mod:`repro_torch.parallel.fsdp`).

Outside a :func:`mesh_context` every helper is a no-op, so the same model
code runs single-device unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch.mesh import AXES
from repro_torch.parallel import collectives as coll
from repro_torch.tree import leaves, tree_map, unflatten

_CTX: contextvars.ContextVar[Optional["MeshCtx"]] = contextvars.ContextVar(
    "repro_torch_mesh_ctx", default=None)


# The parts of a serving tree a rank may hold as shards: "heads" the q/k/v
# column shards (and biases) that give it its own heads, "wo" the
# out projection's rows, "mlp" w_gate/w_up columns with w_down's rows,
# "experts" every expert's w_gate/w_up columns with its w_down rows (the
# router whole), "embedding" its block of vocabulary rows, "lm_head" an
# untied head's block of vocabulary columns; "mamba" the Mamba conv_w
# columns and A_log rows (its block of d_inner), "rwkv_tm" the RWKV time
# mix's wr/wk/wv/wg columns (its heads), "rwkv_cm" the channel mix's
# w_gate and receptance w_up columns with w_down's rows; "attn_cols" (the
# dense slab's, where the model axis does not divide the kv heads) the
# q/k/v column blocks of the reference's specs, gathered after the
# projection, with wo's row block.
PARTS = ("heads", "wo", "mlp", "experts", "embedding", "lm_head", "mamba",
         "rwkv_tm", "rwkv_cm", "attn_cols")
MODES = ("train", "serve", "dense")


class MeshCtx:
    def __init__(self, mesh, rules: Mapping[str, Sequence[str]],
                 mode: str = "train",
                 opts: Optional[Mapping[str, Any]] = None,
                 layout: frozenset = frozenset()):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
        self.mesh = mesh
        self.rules = dict(rules)
        self.mode = mode
        self.opts = dict(opts or {})   # e.g. {'tp_int8_reduce': True}
        self.layout = frozenset(layout)   # the PARTS held as shards

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[name]


def active_ctx() -> Optional[MeshCtx]:
    return _CTX.get()


@contextlib.contextmanager
def mesh_context(mesh, rules: Mapping[str, Sequence[str]],
                 mode: str = "train",
                 opts: Optional[Mapping[str, Any]] = None,
                 layout: frozenset = frozenset()):
    """Make ``mesh`` active for the model code; ``layout``: the parts of
    the params the forward runs on that are this rank's shards (a
    :class:`RankShards` tree's ``layout``)."""
    tok = _CTX.set(MeshCtx(mesh, rules, mode, opts, layout))
    try:
        yield _CTX.get()
    finally:
        _CTX.reset(tok)


def serve_tp() -> tuple:
    """(mesh, model_axis_size) of an active *serving* mesh context, else
    (None, 1).

    The engine enters ``mesh_context(mesh, rules, mode='serve')`` around
    every target forward; the model code (attention's paged branches, the
    row-parallel projections, the vocabulary-sharded embedding and head)
    reads this to decide whether this rank's tensor-parallel code applies.
    """
    ctx = active_ctx()
    if ctx is None or ctx.mode != "serve":
        return None, 1
    size = dict(ctx.mesh.shape).get("model", 1)
    if size <= 1:
        return None, 1
    return ctx.mesh, size


def dense_ctx() -> Optional[MeshCtx]:
    """The active dense-slab mesh context (``mode="dense"``), else None."""
    ctx = active_ctx()
    return ctx if ctx is not None and ctx.mode == "dense" else None


def tp_mesh() -> tuple:
    """(mesh, model_axis_size) of an active serving context, the paged
    engine's (``mode="serve"``) or the dense slab's (``mode="dense"``),
    whose model axis is longer than one; else (None, 1)."""
    ctx = active_ctx()
    if ctx is None or ctx.mode not in ("serve", "dense"):
        return None, 1
    size = dict(ctx.mesh.shape).get("model", 1)
    return (ctx.mesh, size) if size > 1 else (None, 1)


def sharded(part: str) -> bool:
    """Does this rank hold ``part`` (one of :data:`PARTS`) as shards? Only
    inside a serving mesh context (either mode) whose layout lists it."""
    if part not in PARTS:
        raise ValueError(f"unknown part {part!r}: one of {PARTS}")
    mesh, _ = tp_mesh()
    return mesh is not None and part in active_ctx().layout


class Split(NamedTuple):
    """How a step's tokens are split over ranks: ``axes`` every axis
    (longer than one, in mesh order) along which the ranks hold distinct
    tokens, ``n`` their rank count, ``index`` this rank's index among
    them (row-major over ``axes``: member ``index`` of the group over
    ``axes``); ``row_axes`` those of ``axes`` that split the batch's
    rows, ``seq_axes`` those that split its sequence (the multi-pod
    train rules' ``pod``)."""
    mesh: Any
    axes: tuple
    n: int
    index: int
    row_axes: tuple
    seq_axes: tuple

    @property
    def seq_index(self) -> int:
        """This rank's block of the sequence (0 when it is whole)."""
        return _block(self.seq_axes, self.mesh.coords, self.mesh)[0]

    def blocks(self, coords=None) -> tuple:
        """(row block, rows' block count, sequence block, its block
        count) of the rank at ``coords`` (default: this rank)."""
        coords = self.mesh.coords if coords is None else coords
        return (*_block(self.row_axes, coords, self.mesh),
                *_block(self.seq_axes, coords, self.mesh))


def token_split(mesh, row_axes: tuple, seq_axes: tuple = ()) -> Split:
    """The :class:`Split` of a mesh whose ranks hold distinct rows along
    ``row_axes`` and distinct sequence blocks along ``seq_axes``."""
    rows = tuple(a for a in AXES if a in row_axes and mesh.shape[a] > 1)
    seq = tuple(a for a in AXES if a in seq_axes and mesh.shape[a] > 1)
    axes = tuple(a for a in AXES if a in rows + seq)
    idx, n = _block(axes, mesh.coords, mesh)
    return Split(mesh, axes, n, idx, rows, seq)


def data_split() -> Optional[Split]:
    """Under a dense-slab context whose rules split the batch over a data
    axis longer than one: the :class:`Split` of its rows (the kind
    ``parallel.fsdp.batch_split`` gives a sharded train step); None
    otherwise. A rank's rows are then its block of the global batch
    (:func:`batch_block`)."""
    ctx = dense_ctx()
    if ctx is None:
        return None
    axes = tuple(a for a in AXES if a in ctx.rules.get("batch", ())
                 and ctx.mesh.shape[a] > 1)
    if not axes:
        return None
    return token_split(ctx.mesh, axes)


def batch_block(x: torch.Tensor, mesh, rules) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (dim 0 named "batch")
    under ``rules``: a view."""
    spec = spec_for(x.shape[:1], ("batch",), rules, mesh)
    return block_view(x, spec + (None,) * (x.ndim - 1), mesh)


def effective_model_shards(mesh, n_kv_heads: int) -> int:
    """Sharding degree the head-sharded serving path actually gets.

    The ONE copy of the kv-head divisibility rule: the mesh's model-axis
    size when it divides ``n_kv_heads``, else 1 (replicated attention). The
    engine, the page pool, :func:`serve_pspecs` (and through the layout it
    records, the attention routing) and the serve entry point all consult
    this, so page storage and kernel dispatch never disagree about
    whether heads are sharded.
    """
    if mesh is None:
        return 1
    tp = dict(mesh.shape).get("model", 1)
    return tp if tp > 1 and n_kv_heads % tp == 0 else 1


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------
def make_rules(mode: str = "train", multi_pod: bool = False,
               family: str = "dense") -> dict:
    """Logical-name → mesh-axis-candidate tuples (greedy prefix binding).

    The reference's tables (see its docstring for the layout decisions):
    ``train`` is flat FSDP (recurrent families keep the batch on data and
    put heads / d_inner on model), ``prefill``/``decode`` the dense-slab
    TP with a sequence-sharded KV cache, and ``serve`` the paged engine's
    head-sharded TP: page storage and the q/k/v head dims carry the model
    axis, so paged attention is shard-local and the row-parallel wo /
    w_down outputs are the only reductions a layer.
    """
    data = ("pod", "data") if multi_pod else ("data",)
    weights = {
        "fsdp": ("data",) if mode == "train" else (),
        "heads_flat": ("model",),
        "d_ff": ("model",),
        "vocab": ("model",),
        "head_dim": (), "embed": (), "ssm_state": (), "conv_dim": (),
        "moe_capacity": (),
    }
    if mode == "train":
        recurrent = family in ("ssm", "hybrid")
        return {
            **weights,
            "batch": ("data",) if recurrent else ("data", "model"),
            "batch_out": ("data",),
            "seq_act": ("pod",) if multi_pod else (),
            "seq": (),
            "heads": ("model",) if recurrent else (),
            "kv_heads": (),
            "ssm_inner": ("model",),
            "expert": ("model",),
            "expert_ff": (),
            "moe_group": ("data",),
            "seq_kv": (),
        }
    if mode in ("prefill", "decode"):
        return {
            **weights,
            "batch": data,
            "batch_out": data,
            "seq_act": (),
            "seq": (),
            "heads": ("model",),
            "kv_heads": ("model",),
            "ssm_inner": ("model",),
            "expert": data,
            "expert_ff": ("model",),
            "moe_group": (),
            "seq_kv": ("model",),
        }
    if mode == "serve":
        return {
            **weights,
            "batch": data,
            "batch_out": data,
            "seq_act": (),
            "seq": (),
            "heads": ("model",),
            "kv_heads": ("model",),
            "kv_pages": (),
            "ssm_inner": ("model",),
            "expert": data,
            "expert_ff": ("model",),
            "moe_group": (),
            "seq_kv": (),
        }
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Spec resolution
# ---------------------------------------------------------------------------
def spec_for(shape: Sequence[int], names: Sequence[Optional[str]],
             rules: Mapping[str, Sequence[str]], mesh) -> tuple:
    """The spec of a ``shape`` whose dims carry logical ``names``.

    Divisibility- and reuse-checked: a mesh axis binds to at most one dim,
    and only when it divides the dim (joint axes as a product).
    """
    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} vs names {tuple(names)}")
    used: set = set()
    out = []
    for dim, name in zip(shape, names):
        if not name:
            out.append(None)
            continue
        axes = [a for a in rules.get(name, ())
                if a in mesh.shape and a not in used]
        bound, prod = [], 1
        for a in axes:        # the longest dividing prefix, greedily
            if dim % (prod * mesh.shape[a]) == 0:
                bound.append(a)
                prod *= mesh.shape[a]
        if bound:
            used.update(bound)
            out.append(tuple(bound) if len(bound) > 1 else bound[0])
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter logical axes by path pattern
# ---------------------------------------------------------------------------
# Matched in order against '/'-joined param paths. First hit wins.
_PARAM_PATTERNS: list[tuple[str, tuple]] = [
    (r"embedding$",            ("vocab", "fsdp")),
    (r"lm_head$",              ("fsdp", "vocab")),
    (r"(wq|wk|wv|wr|wg)$",     ("fsdp", "heads_flat")),
    (r"(wq|wk|wv)_bias$",      ("heads_flat",)),
    (r"wo$",                   ("heads_flat", "fsdp")),
    (r"(w_gate|w_up)$",        ("fsdp", "d_ff")),
    (r"w_down$",               ("d_ff", "fsdp")),
    (r"router$",               ("fsdp", None)),
    (r"experts/(w_gate|w_up)$", ("expert", "fsdp", "expert_ff")),
    (r"experts/w_down$",       ("expert", "expert_ff", "fsdp")),
    (r"(in_proj|x_proj|rkvg|time_maa_w[12]|w_lora_[ab]|dt_proj)$", ("fsdp", None)),
    (r"out_proj$",             (None, "fsdp")),
    (r"conv_w$",               (None, "ssm_inner")),
    (r"A_log$",                ("ssm_inner", None)),
    (r"(scale|bias|norm|A|D|dt_bias|time_.*|w0|u|ln_[xw].*|g_norm.*)$", None),
]


def _axes_for_path(path: str, ndim: int):
    for pat, axes in _PARAM_PATTERNS:
        if re.search(pat, path):
            if axes is None:
                return (None,) * ndim
            if len(axes) == ndim:
                return axes
            if len(axes) < ndim:  # leading batch-ish dims unsharded
                return (None,) * (ndim - len(axes)) + tuple(axes)
            return axes[:ndim]
    return (None,) * ndim


# 'heads_flat' (= n_heads*head_dim or n_kv*head_dim columns) shards over
# model when divisible, independent of whether per-head activations shard.
_EXTRA_RULES = {"heads_flat": ("model",)}


class QSpec:
    """The specs of a QuantizedTensor's payload and its (1, N) scale (the
    reference returns them in a QuantizedTensor of specs)."""

    def __init__(self, q: tuple, scale: tuple):
        self.q, self.scale = q, scale

    def __eq__(self, other):
        return (isinstance(other, QSpec)
                and (self.q, self.scale) == (other.q, other.scale))

    def __repr__(self):
        return f"QSpec(q={self.q}, scale={self.scale})"


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def params_pspecs(params_tree: Any, rules: Mapping[str, Sequence[str]],
                  mesh) -> Any:
    """Spec tree for a params tree, by path patterns. QuantizedTensor
    leaves get a :class:`QSpec`: the payload's spec from its own (packed)
    shape, the scale's last dim following the payload's columns."""
    full_rules = {**rules, **_EXTRA_RULES}

    def one(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            axes = _axes_for_path(path, leaf.q.ndim)
            qspec = spec_for(leaf.q.shape, axes, full_rules, mesh)
            sspec = (None,) * (leaf.scale.ndim - 1) + (
                qspec[-1] if len(qspec) else None,)
            return QSpec(qspec, sspec)
        axes = _axes_for_path(path, len(leaf.shape))
        return spec_for(leaf.shape, axes, full_rules, mesh)

    return _walk(params_tree, one)


# ---------------------------------------------------------------------------
# One rank's shards
# ---------------------------------------------------------------------------
class RankShards(dict):
    """A params tree holding one rank's shards (:func:`shard_params`'s
    output); the engine takes it as it is. ``layout``: the :data:`PARTS`
    it holds as shards; ``whole_bytes``: the bytes of the whole tree it
    was cut from (:func:`tree_bytes`)."""

    def __init__(self, tree, layout=frozenset(), whole_bytes: int = 0):
        super().__init__(tree)
        self.layout = frozenset(layout)
        self.whole_bytes = int(whole_bytes)


_ATTN = ("wq", "wk", "wv", "wq_bias", "wk_bias", "wv_bias", "wo")


def _replicated(spec):
    if isinstance(spec, QSpec):
        return QSpec((None,) * len(spec.q), (None,) * len(spec.scale))
    return (None,) * len(spec)


def _is_sharded(spec) -> bool:
    s = spec.q if isinstance(spec, QSpec) else spec
    return any(a is not None for a in s)


def runs_dense_slab(cfg) -> bool:
    """Does ``serving.engine.generate`` send ``cfg`` to the dense-slab
    loop (a recurrent mixer, or float embedding inputs), as the reference
    does? Every other config runs on the paged engine."""
    return cfg.embedding_inputs or any(cfg.mixer_of(i) != "attn"
                                       for i in range(cfg.n_layers))


def for_dense_slab(cfg) -> bool:
    """Are shards cut now for the dense slab: inside its mesh context
    (``mode="dense"``), or of a config only the dense slab serves
    (:func:`runs_dense_slab`)? Otherwise they are the paged engine's."""
    return dense_ctx() is not None or runs_dense_slab(cfg)


def serve_pspecs(params: Any, mesh, cfg, rules=None) -> Any:
    """:func:`params_pspecs` under the serve rules, made to match what a
    rank computes eagerly, where GSPMD would gather:

    * attention whose kv heads the model axis does not divide
      (``effective_model_shards`` 1) runs replicated on the paged engine,
      so its q/k/v/o weights stay whole there. The dense slab
      (:func:`for_dense_slab`) keeps the reference's specs: the rank's
      q/k/v columns, gathered after the projection, and wo's rows (the
      ``"attn_cols"`` part: ``models.attention``);
    * a gated MLP whose ``w_down`` cannot be K-sharded (``tp_shardable``:
      a packed int4 shard needs an even number of rows) keeps ``w_gate``
      and ``w_up`` whole too; so do the experts, by their ``w_down``.

    * a recurrent part whose leaves do not all split keeps them all
      whole: an RWKV time mix whose wr/wk/wv/wg columns would cut a head
      (the rank computes whole heads), an RWKV channel mix whose
      w_gate/w_up/w_down do not all split, a Mamba layer whose conv_w and
      A_log do not both split.

    Every other spec is the reference's. Its patterns match an expert
    stack's ``w_gate`` / ``w_up`` / ``w_down`` as the dense MLP's (the
    first hit wins), so the expert dim stays whole: every rank holds a
    column or row block of every expert, as under the reference's serve
    (and prefill / decode) rules. The recurrent specs that result: RWKV
    wr/wk/wv/wg by columns, its out_proj, time_maa_w* and w_lora_* whole,
    the channel mix's w_gate / w_up by columns and w_down by rows; Mamba
    conv_w by columns and A_log by rows, its in/x/dt/out projections
    whole.
    """
    specs = params_pspecs(params, rules or make_rules("serve"), mesh)
    whole_attn = (effective_model_shards(mesh, cfg.n_kv_heads) == 1
                  and not for_dense_slab(cfg))
    tp = dict(mesh.shape).get("model", 1)
    for layer in specs.get("layers", []):
        attn = layer.get("attn")
        if attn is not None and whole_attn:
            for k in _ATTN:
                if k in attn:
                    attn[k] = _replicated(attn[k])
        for ffn in (layer.get("mlp"), layer.get("moe", {}).get("experts")):
            if ffn is not None and not _is_sharded(ffn["w_down"]):
                for k in ("w_gate", "w_up"):
                    ffn[k] = _replicated(ffn[k])
        whole_heads = (cfg.d_model // tp) % cfg.rwkv_head_dim == 0
        for key, names, ok in (
                ("rwkv_tm", ("wr", "wk", "wv", "wg"), whole_heads),
                ("rwkv_cm", ("w_gate", "w_up", "w_down"), True),
                ("mamba", ("conv_w", "A_log"), True)):
            part = layer.get(key)
            if part is None:
                continue
            if not (ok and all(_is_sharded(part[k]) for k in names)):
                for k in names:
                    part[k] = _replicated(part[k])
    return specs


# (part, path in a layer of the leaf whose spec says whether it is sharded)
_LAYER_PARTS = (("heads", ("attn", "wq")), ("wo", ("attn", "wo")),
                ("mlp", ("mlp", "w_down")),
                ("experts", ("moe", "experts", "w_down")),
                ("mamba", ("mamba", "conv_w")),
                ("rwkv_tm", ("rwkv_tm", "wr")),
                ("rwkv_cm", ("rwkv_cm", "w_down")))


def _layout(specs) -> frozenset:
    """The :data:`PARTS` a :func:`serve_pspecs` tree shards; every layer
    that holds a part must shard it alike (llama4's dense and MoE layers
    alternate: its dense layers hold "mlp", its MoE layers "experts")."""
    parts = {part for part in ("embedding", "lm_head")
             if part in specs and _is_sharded(specs[part])}
    for part, path in _LAYER_PARTS:
        seen = set()
        for layer in specs.get("layers", []):
            node = layer
            for key in path:
                node = node.get(key) if isinstance(node, dict) else None
            if node is not None:
                seen.add(_is_sharded(node))
        if len(seen) > 1:
            raise ValueError(f"layers shard {part!r} apart")
        if True in seen:
            parts.add(part)
    return frozenset(parts)


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(entry, coords, mesh) -> tuple:
    """(index, count) of the block a rank at ``coords`` holds along a dim
    whose spec entry is ``entry``: row-major over its joint axes."""
    n, idx = 1, 0
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def block_view(x: torch.Tensor, spec: tuple, mesh, coords=None
               ) -> torch.Tensor:
    """The block of ``x`` under ``spec`` that the rank at ``coords``
    (default: this rank) holds, as a view."""
    coords = mesh.coords if coords is None else coords
    for dim, entry in enumerate(spec):
        idx, n = _block(entry, coords, mesh)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


def block_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of the block of a whole ``shape`` that a rank holds under
    ``spec``."""
    return tuple(d // _block(e, mesh.coords, mesh)[1]
                 for d, e in zip(shape, spec))


def _slice(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``, copied out so that the
    full tensor's storage can be freed."""
    return block_view(x, spec, mesh).clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh, cfg, rules=None) -> RankShards:
    """This rank's local tree: every leaf sliced by :func:`serve_pspecs`
    (the paged engine's, or under :func:`for_dense_slab` the dense
    slab's: attention whose kv heads the model axis does not divide whole
    on the one, in the reference's column blocks on the other).

    A QuantizedTensor column shard slices the payload and its (1, N) scale
    (an expert stack's (E, 1, N)) together; a row shard slices the
    payload's (packed) K rows and keeps the scale. Replicated leaves are
    kept as they are (the same tensors). The result's ``layout`` lists the
    parts sharded. Any part of a params tree (the top without its layers,
    one layer as ``{"layers": [...]}``) shards alike; every family does
    (``rules``: the serve rules by default; the prefill and decode rules
    place the weights alike).
    """
    specs = serve_pspecs(params, mesh, cfg, rules)
    layout = _layout(specs)
    if effective_model_shards(mesh, cfg.n_kv_heads) == 1 \
            and layout & {"heads", "wo"}:       # the dense slab's columns
        layout = (layout - {"heads", "wo"}) | {"attn_cols"}

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return shard_leaf(tree, spec, mesh)

    return RankShards(walk(params, specs), layout, tree_bytes(params))


def _qt(q, scale, like: QuantizedTensor) -> QuantizedTensor:
    """A QuantizedTensor of ``like``'s bits over payload ``q``, its logical
    shape read from ``q`` (packed int4 rows count twice)."""
    rows = q.shape[-2] * (2 if like.bits == 4 else 1)
    return QuantizedTensor(q=q, scale=scale, bits=like.bits,
                           shape=(*like.shape[:-2], rows, q.shape[-1]))


def shard_leaf(leaf, spec, mesh):
    """This rank's block of a whole leaf (a copy; the leaf itself where
    ``spec`` shards nothing). A QuantizedTensor column shard slices the
    payload and its (1, N) scale together; a row shard slices the
    payload's (packed) K rows and keeps the scale."""
    if not _is_sharded(spec):
        return leaf
    if isinstance(leaf, QuantizedTensor):
        return _qt(_slice(leaf.q, spec.q, mesh),
                   _slice(leaf.scale, spec.scale, mesh), leaf)
    return _slice(leaf, spec, mesh)


# The logical names of the dense slab's caches, by leaf name (the
# reference's ``launch/dryrun.py::_CACHE_AXES``).
_CACHE_AXES = {
    "k": ("batch", "kv_heads", "seq_kv", None),
    "v": ("batch", "kv_heads", "seq_kv", None),
    "kv_scale": ("batch", "kv_heads", None),
    "h": ("batch", "ssm_inner", None),
    "conv": ("batch", None, "ssm_inner"),
    "s": ("batch", "heads", None, None),
    "x_prev": ("batch", None),
}


def _is_slab(node) -> bool:
    return all(hasattr(node, a) for a in ("k", "v", "k_scale", "v_scale",
                                          "page_size"))


def cache_pspecs(tree: Any, rules: Mapping[str, Sequence[str]], mesh) -> Any:
    """Spec tree of the dense slab's caches (``serving.engine.
    init_serve_caches``' tree; the shapes are read, so meta tensors do),
    as the reference's ``launch/dryrun.py::cache_pspecs`` gives it: a
    ``DenseKVCache`` becomes ``{"k", "v", "k_scale", "v_scale"}`` (the
    scales None for a float slab), every state by its leaf name. Under
    ``spec_for`` a kv slab binds the model axis to its kv heads when it
    divides them, else (the prefill / decode rules) to its positions.
    The reference's per-page scales name no sequence dim, so its spec
    keeps them whole; a rank's slab holds the scales of its own pages
    (``DenseKVCache.start``)."""
    def leaf(x, name):
        names = _CACHE_AXES.get(name, (None,) * x.ndim)
        return spec_for(x.shape, names, rules, mesh)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if _is_slab(node):
            return {"k": leaf(node.k, "k"), "v": leaf(node.v, "v"),
                    **{f"{c}_scale": None if getattr(node, f"{c}_scale")
                       is None else leaf(getattr(node, f"{c}_scale"),
                                         "kv_scale") for c in "kv"}}
        return leaf(node, name)

    return walk(tree)


def tree_bytes(tree: Any) -> int:
    """The bytes of a tree's tensors (QuantizedTensor payloads and scales
    counted, a leaf shared by two paths once)."""
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            total += x.numel() * x.element_size()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, QuantizedTensor):
            add(node.q)
            add(node.scale)
        elif _is_slab(node):
            for a in ("k", "v", "k_scale", "v_scale"):
                add(getattr(node, a))
        else:
            add(node)

    walk(tree)
    return total


def live_axes(spec, mesh) -> tuple:
    """The mesh axes longer than one that ``spec`` binds, in mesh order."""
    used = {a for entry in spec for a in axes_of(entry)}
    return tuple(a for a in AXES if a in used and mesh.shape[a] > 1)


# ---------------------------------------------------------------------------
# Training: a train state's shards
# ---------------------------------------------------------------------------
class NamedSharding:
    """A leaf's spec on a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def train_state_pspecs(state: Any, rules: Mapping[str, Sequence[str]],
                       mesh) -> Any:
    """Spec tree of a whole train state ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` (the leaves' shapes are read; meta tensors do):
    the params by :func:`params_pspecs`; each moment as its parameter (an
    int8 moment's payload as the parameter, its (..., 1) row scales with
    the last dim whole); the counters replicated."""
    pspecs = params_pspecs(state["params"], rules, mesh)

    def moment(spec, m):
        if isinstance(m, dict):
            return {"q": spec, "scale": spec[:-1] + (None,)}
        return spec
    opt = {k: v for k, v in state["opt"].items() if k not in ("m", "v")}
    return {"params": pspecs,
            "opt": {**{k: (None,) * v.ndim for k, v in opt.items()},
                    **{k: tree_map(moment, pspecs, state["opt"][k])
                       for k in ("m", "v")}},
            "step": (None,) * state["step"].ndim}


def named(specs: Any, mesh) -> Any:
    """A spec tree → the same tree of :class:`NamedSharding` on ``mesh``."""
    return unflatten(specs, [NamedSharding(mesh, spec)
                             for spec in leaves(specs)])


def shard_tree(tree: Any, shardings: Any) -> Any:
    """This rank's shards of a whole ``tree`` (the same on every rank) by a
    matching tree of :class:`NamedSharding`."""
    return unflatten(tree, [shard_leaf(x, sh.spec, sh.mesh) for x, sh in
                            zip(leaves(tree), leaves(shardings))])


def gather_tree(tree: Any, shardings: Any) -> Any:
    """The whole tree from this rank's shards (a collective: every rank of
    the shardings' mesh calls it). The blocks of all the leaves gathered
    over one group of axes (in one dtype) travel in one all-gather.
    Tensor leaves only: a QuantizedTensor leaf raises ``TypeError``."""
    xs, shs = leaves(tree), leaves(shardings)
    out = list(xs)
    buckets: dict = {}
    for i, (x, sh) in enumerate(zip(xs, shs)):
        if isinstance(x, QuantizedTensor):
            raise TypeError("gather_tree gathers tensors; a sharded "
                            "QuantizedTensor leaf has no gather yet")
        if live_axes(sh.spec, sh.mesh):
            key = (id(sh.mesh), live_axes(sh.spec, sh.mesh), x.dtype)
            buckets.setdefault(key, []).append(i)
    for (_, axes, _), idx in buckets.items():
        mesh = shs[idx[0]].mesh
        parts = coll.gather_blocks(torch.cat([xs[i].reshape(-1)
                                              for i in idx]), mesh, axes)
        for i in idx:
            out[i] = xs[i].new_empty(
                [d * _block(e, mesh.coords, mesh)[1]
                 for d, e in zip(xs[i].shape, shs[i].spec)])
        for j, part in enumerate(parts):
            coords = mesh.member_coords(axes, j)
            for i, piece in zip(idx, part.split([xs[i].numel()
                                                 for i in idx])):
                block_view(out[i], shs[i].spec, mesh, coords).copy_(
                    piece.view(xs[i].shape))
    return unflatten(tree, out)
