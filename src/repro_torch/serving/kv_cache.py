"""KV caches: the dense slab, and write-once token-granular pages in a
shared pool.

Port of ``repro/serving/kv_cache.py``: :class:`DenseKVCache`, the paged
pool and its two views. Pages and slabs hold int8 with scales, or float in
the model dtype with no scales.

* **int8 storage with per-token scales**: each (page, kv head, token) row
  carries its own scale, ``max(amax / 127, 1e-8)`` over the head dim. A
  token's stored bytes depend on its own values only, so pages are
  write-once: the cache after N tokens is bit-identical however the writes
  were grouped, and :meth:`PagePool.truncate` rolls back exactly.
* **paging**: KV lives in fixed-size pages owned by a pool; per-sequence
  block tables map positions to page slots. Pages are reference counted:
  prompts sharing a prefix share the physical pages holding it (a trie keyed
  by page-sized token chunks), :meth:`PagePool.fork` clones a sequence in
  O(1), and writes go through :meth:`PagePool.ensure_writable`
  (copy-on-write). Trie-indexed pages whose last reference dies are retained
  in a bounded LRU, so a re-submitted prompt re-shares them.

**In-place page storage.** The reference is functional: a cache view's
``append``/``write_chunk`` return new page arrays and the engine stores them
back with :meth:`PagePool.writeback`. Here the views hold the pool's own
tensors and update them in place (``index_put_``), which saves a copy of
every layer's pages per step; ``writeback`` only re-binds the view's tensors
(the same objects) to the pool.

**The dense slab.** :class:`DenseKVCache` is the (B, KV, T, hd) slab of the
dense serving path (the loop that recurrent mixers need, and the plain
baseline of the paged engine). int8 slabs carry one scale per (batch, head,
page); appending a token requantizes its page. It too updates in place.
Under a serving mesh a rank's slab holds its block of the rows and of the
kv heads, or, under the prefill / decode rules where the model axis does
not divide the kv heads, its block of the positions from ``start`` on
(``seq_axes`` the mesh axes they split over): whole pages of an int8
slab, with their scales.

The int8 conversion divides by 127 and by the scale with correctly rounded
divisions, as the reference's eagerly-run cache ops do (see
:func:`repro_torch.core.quant.div_exact`).

**Head-sharded storage.** Under tensor-parallel serving each rank's pool
(``PagePool(mesh=...)``, when the mesh's model axis divides the kv heads)
holds its ``n_kv_heads / tp`` heads of every page, scales alike: (P,
KV/tp, ps, hd) a layer. The control state (free list, refcounts, block
tables, prefix trie, LRU) is replicated: every rank runs the same
scheduler on the same requests, so it stays equal on every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import div_exact
from repro_torch.parallel.sharding import (_block, axes_of,
                                           effective_model_shards)

INT8_AMAX = 127.0
SCALE_EPS = 1e-8          # floor so all-zero rows dequantize to exact zeros
DEFAULT_PAGE_SIZE = 16


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# int8 conversion
# ---------------------------------------------------------------------------
def int8_scale(x: torch.Tensor, dim) -> torch.Tensor:
    """Symmetric dynamic scale: amax over ``dim`` / 127, floored."""
    amax = x.float().abs().amax(dim=dim)
    return torch.clamp(div_exact(amax, INT8_AMAX), min=SCALE_EPS)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-half-even symmetric int8; ``scale`` broadcasts against ``x``."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -INT8_AMAX, INT8_AMAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype
                    ) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _chunk_to_pages(x: torch.Tensor, n_pages: int, page_size: int
                    ) -> torch.Tensor:
    """(1, KV, S, hd) float → (n_pages, KV, page_size, hd) f32, zero-padded
    past S (the one pipeline all page-block writes go through)."""
    kv, s, hd = x.shape[1], x.shape[2], x.shape[3]
    xp = x.new_zeros((kv, n_pages * page_size, hd), dtype=torch.float32)
    xp[:, :s] = x[0].float()
    return xp.reshape(kv, n_pages, page_size, hd).transpose(0, 1)


def _quantize_page_block(xp: torch.Tensor):
    """(np, KV, ps, hd) f32 → (int8 payload, (np, KV, ps) per-token scales)."""
    sc = int8_scale(xp, dim=3)
    return quantize_int8(xp, sc[..., None]), sc


def _quantize_pages(x: torch.Tensor, page_size: int):
    """x (..., T, hd), T a page multiple → (int8 (..., T, hd), scales
    (..., T // page_size)): one scale per (lead..., page)."""
    lead, (t, hd) = x.shape[:-2], x.shape[-2:]
    paged = x.reshape(*lead, t // page_size, page_size, hd)
    scale = int8_scale(paged, dim=(-2, -1))                  # (..., n_pages)
    q = quantize_int8(paged, scale[..., None, None])
    return q.reshape(*lead, t, hd), scale


# ---------------------------------------------------------------------------
# Dense slab cache (the dense serving path)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DenseKVCache:
    """(B, KV, T, hd) KV slab, updated in place. int8 storage carries
    per-page scales ``k_scale``/``v_scale`` (B, KV, T // page_size) f32;
    float storage has None. ``start``: the first position the slab holds
    (a rank's block of a sequence-split slab; 0 otherwise), ``seq_axes``:
    the mesh axes its positions split over (empty: the slab is whole
    along the sequence)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_size: int
    start: int = 0
    seq_axes: tuple = ()

    @classmethod
    def init(cls, batch: int, n_kv_heads: int, max_len: int, head_dim: int,
             dtype, *, quantized: bool = False,
             page_size: int = DEFAULT_PAGE_SIZE, device=None,
             start: int = 0, seq_axes: tuple = ()) -> "DenseKVCache":
        """Zero slabs of ``max_len`` positions from ``start`` on; an int8
        slab is padded to whole pages (a block of a sequence-split one
        must start on a page)."""
        kw = dict(page_size=page_size, start=start, seq_axes=tuple(seq_axes))
        if not quantized:
            shape = (batch, n_kv_heads, max_len, head_dim)
            return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       k_scale=None, v_scale=None, **kw)
        if start % page_size:
            raise ValueError(f"an int8 slab block starts on a page: start "
                             f"{start}, page {page_size}")
        t = round_up(max_len, page_size)
        shape = (batch, n_kv_heads, t, head_dim)
        sshape = (batch, n_kv_heads, t // page_size)

        def scales():
            return torch.full(sshape, SCALE_EPS, dtype=torch.float32,
                              device=device)
        return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                   v=torch.zeros(shape, dtype=torch.int8, device=device),
                   k_scale=scales(), v_scale=scales(), **kw)

    def rank_block(self, spec: dict, mesh, device=None) -> "DenseKVCache":
        """This rank's zero block of this whole slab (its shapes are read:
        a meta slab does) under ``spec`` (its :func:`~repro_torch.
        parallel.sharding.cache_pspecs` entry): its rows, its kv heads,
        or its positions. Split positions are padded so that every rank
        holds as many whole pages (an int8 slab), from ``start`` on."""
        b, kv, t, hd = self.k.shape
        (_, nb), (_, nh), (idx, n) = (_block(e, mesh.coords, mesh)
                                      for e in spec["k"][:3])
        blk, start = t, 0
        if n > 1:
            ps = self.page_size
            blk = round_up(t, ps * n) // n if self.quantized else t // n
            start = idx * blk
        return DenseKVCache.init(
            b // nb, kv // nh, blk, hd, self.k.dtype,
            quantized=self.quantized, page_size=self.page_size,
            device=device, start=start,
            seq_axes=axes_of(spec["k"][2]) if n > 1 else ())

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def write_prefill(self, k_t: torch.Tensor, v_t: torch.Tensor
                      ) -> "DenseKVCache":
        """Fill positions [0, S) from (B, KV, S, hd) keys/values (those of
        them the slab holds); an int8 slab quantizes whole pages,
        zero-padded past S."""
        s, lo = k_t.shape[2], self.start
        if not self.quantized:
            hi = min(s, lo + self.max_len) if self.seq_axes else s
            if hi > lo:
                self.k[:, :, :hi - lo] = k_t[:, :, lo:hi]
                self.v[:, :, :hi - lo] = v_t[:, :, lo:hi]
            return self
        ps = self.page_size
        t = round_up(s, ps)
        hi = min(t, lo + self.max_len) if self.seq_axes else t
        if hi <= lo:
            return self
        for slab, scales, x in ((self.k, self.k_scale, k_t),
                                (self.v, self.v_scale, v_t)):
            if t != s:
                x = F.pad(x.float(), (0, 0, 0, t - s))
            q, sc = _quantize_pages(x[:, :, lo:hi], ps)
            slab[:, :, :hi - lo] = q
            scales[:, :, :(hi - lo) // ps] = sc
        return self

    def append(self, k_t: torch.Tensor, v_t: torch.Tensor, pos: int
               ) -> "DenseKVCache":
        """Write one token (B, KV, 1, hd) at position ``pos``. An int8 slab
        dequantizes the token's page, inserts the token (positions past it
        become zero), and requantizes the page with a new scale. A block
        of a sequence-split slab writes only a position it holds."""
        pos = int(pos) - self.start
        if self.seq_axes and not 0 <= pos < self.max_len:
            return self
        if not self.quantized:
            self.k[:, :, pos] = k_t[:, :, 0]
            self.v[:, :, pos] = v_t[:, :, 0]
            return self
        ps = self.page_size
        page = pos // ps
        start, off = page * ps, pos - page * ps
        idx = torch.arange(ps, device=self.k.device)
        keep = (idx < off)[None, None, :, None]
        ins = (idx == off)[None, None, :, None]
        for slab, scales, new in ((self.k, self.k_scale, k_t),
                                  (self.v, self.v_scale, v_t)):
            pf = slab[:, :, start:start + ps].float() \
                * scales[:, :, page][..., None, None]        # (B,KV,ps,hd)
            pf = torch.where(keep, pf, 0.0) + new.float() * ins
            sc = int8_scale(pf, dim=(2, 3))                   # (B, KV)
            slab[:, :, start:start + ps] = quantize_int8(pf, sc[..., None, None])
            scales[:, :, page] = sc
        return self

    def read(self, out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dequantized contents: ((B, T, KV, hd), (B, T, KV, hd))."""
        if not self.quantized:
            return (self.k.transpose(1, 2).to(out_dtype),
                    self.v.transpose(1, 2).to(out_dtype))
        b, kv, t, hd = self.k.shape
        ps = self.page_size

        def deq(slab, scales):
            paged = slab.reshape(b, kv, t // ps, ps, hd)
            f = dequantize_int8(paged, scales[..., None, None], out_dtype)
            return f.reshape(b, kv, t, hd).transpose(1, 2)

        return deq(self.k, self.k_scale), deq(self.v, self.v_scale)


# ---------------------------------------------------------------------------
# Per-step views that flow through forward()
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagedDecodeCache:
    """One attention layer's pages for one batched decode step.

    ``k_pages``/``v_pages``: (P, KV, ps, hd) int8, or the model dtype;
    ``k_scale``/``v_scale``: (P, KV, ps) f32, None for float pages;
    ``tables``: (B, max_pages) int32 (rows padded with slot 0 past a
    sequence's last page); ``lengths``: (B,) int32 tokens cached.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> "PagedDecodeCache":
        """Write one token per sequence, k_new/v_new (B, KV, hd), into its
        (page, offset) row: a write-once scatter, no neighbour requantized.
        Sequences own disjoint pages, so the scatter never collides."""
        ps = self.page_size
        lengths = self.lengths.long()
        slot = torch.gather(self.tables.long(), 1, (lengths // ps)[:, None])[:, 0]
        off = lengths % ps
        for pages, scales, new in ((self.k_pages, self.k_scale, k_new),
                                   (self.v_pages, self.v_scale, v_new)):
            if scales is None:
                pages[slot, :, off] = new.to(pages.dtype)
                continue
            sc = int8_scale(new, dim=-1)                           # (B, KV)
            pages[slot, :, off] = quantize_int8(new, sc[..., None])
            scales[slot, :, off] = sc
        return dataclasses.replace(self, lengths=self.lengths + 1)


@dataclasses.dataclass
class PagedPrefillCache:
    """One attention layer's pages for one sequence's multi-token chunk.

    Pages and scales as in :class:`PagedDecodeCache`. ``table``: (max_pages,) int32 — this sequence's block table.
    ``q_start``: tokens cached before this chunk. The prefill lane keeps it
    page-aligned; a chunk that resumes mid-page takes the token-scatter
    path. ``pages_per_step``: pages the prefill kernel stages per step.
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    table: torch.Tensor
    q_start: int
    pages_per_step: int = 1

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    def write_chunk(self, k_t: torch.Tensor, v_t: torch.Tensor
                    ) -> "PagedPrefillCache":
        """Quantize a chunk's KV (1, KV, C, hd) into [q_start, q_start + C).

        Page-aligned starts write whole pages (zero-padded past the chunk,
        as the reference); unaligned starts scatter per token so the earlier
        tokens of a partial page keep their bytes. Each token is quantized
        once, from its exact values, with its own scale; float pages store
        the values in the page dtype.
        """
        ps = self.page_size
        c = k_t.shape[2]
        table = self.table.long()
        for pages, scales, x in ((self.k_pages, self.k_scale, k_t),
                                 (self.v_pages, self.v_scale, v_t)):
            if self.q_start % ps == 0:
                p0 = self.q_start // ps
                n_w = -(-c // ps)
                slots = table[p0:p0 + n_w]
                xp = _chunk_to_pages(x, n_w, ps)
                if scales is None:
                    pages[slots] = xp.to(pages.dtype)
                    continue
                xq, sc = _quantize_page_block(xp)
                pages[slots] = xq
                scales[slots] = sc
            else:
                pos = self.q_start + torch.arange(c, device=table.device)
                slots, offs = table[pos // ps], pos % ps
                tok = x[0].transpose(0, 1)                         # (C, KV, hd)
                if scales is None:
                    pages[slots, :, offs] = tok.to(pages.dtype)
                    continue
                sc = int8_scale(tok, dim=-1)                       # (C, KV)
                pages[slots, :, offs] = quantize_int8(tok, sc[..., None])
                scales[slots, :, offs] = sc
        return self


# ---------------------------------------------------------------------------
# Prefix-sharing trie (one node per full page of prompt tokens)
# ---------------------------------------------------------------------------
class _PrefixNode:
    """Trie node: one physical page holding one page-sized token chunk."""
    __slots__ = ("slot", "children")

    def __init__(self, slot: int):
        self.slot = slot
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}


# ---------------------------------------------------------------------------
# Page pool (host-side allocator shared by all layers of a model)
# ---------------------------------------------------------------------------
class PagePool:
    """Fixed pool of KV pages + refcounted allocation + block tables + a
    prefix-sharing trie (the reference's ``PagePool`` host logic).

    Pages are int8 with per-token scales (``quantized=True``), or ``dtype``
    with no scales.

    One page slot spans every layer (each layer keeps its own (P, KV, ps,
    hd) tensors; a sequence's block table indexes all of them). Admission is
    conservative: :meth:`reserve` claims the worst-case page count up front.
    Every slot carries a refcount of table references; the trie holds none.
    Shared pages are immutable through any table: writers go through
    :meth:`ensure_writable` (copy-on-write). A trie-indexed page whose last
    reference dies is retained in an LRU of ``retain_pages`` slots (default
    the whole pool) with its trie entry intact; allocation evicts LRU-first.
    :meth:`truncate` rewinds a sequence, as pure metadata.

    With ``mesh=`` (a serving mesh whose model axis divides ``n_kv_heads``,
    see :func:`~repro_torch.parallel.sharding.effective_model_shards`) the
    page and scale storage holds this rank's heads only (:attr:`sharded`);
    an indivisible head count gives an unsharded pool.
    """

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 num_pages: int, page_size: int = DEFAULT_PAGE_SIZE,
                 quantized: bool = True, dtype=torch.bfloat16,
                 mesh=None, retain_pages: Optional[int] = None, device=None):
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.quantized = quantized
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        shards = effective_model_shards(mesh, n_kv_heads)
        self.mesh = mesh if shards > 1 else None
        self.local_kv_heads = n_kv_heads // shards
        shape = (num_pages, self.local_kv_heads, page_size, head_dim)
        sshape = (num_pages, self.local_kv_heads, page_size)
        page_dtype = torch.int8 if quantized else dtype

        def pages():
            return torch.zeros(shape, dtype=page_dtype, device=self.device)

        def scales():
            if not quantized:
                return None
            return torch.full(sshape, SCALE_EPS, dtype=torch.float32,
                              device=self.device)

        self.k_pages: List[torch.Tensor] = [pages() for _ in range(n_layers)]
        self.v_pages: List[torch.Tensor] = [pages() for _ in range(n_layers)]
        self.k_scale: List[Optional[torch.Tensor]] = [
            scales() for _ in range(n_layers)]
        self.v_scale: List[Optional[torch.Tensor]] = [
            scales() for _ in range(n_layers)]
        self.free: List[int] = list(range(num_pages))
        self.ref: List[int] = [0] * num_pages
        self.tables: Dict[int, List[int]] = {}
        self.lens: Dict[int, int] = {}
        self.retain_pages = num_pages if retain_pages is None else retain_pages
        self._retained: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()          # LRU: oldest first
        self._prefix_root = _PrefixNode(-1)
        self._prefix_nodes: Dict[int, Tuple[_PrefixNode, Tuple[int, ...]]] = {}

    @property
    def sharded(self) -> bool:
        """Page storage head-sharded over a mesh's model axis?"""
        return self.mesh is not None

    # -- accounting ------------------------------------------------------
    @property
    def num_free(self) -> int:
        """Reclaimable slots: truly free plus retained (evictable) ones."""
        return len(self.free) + len(self._retained)

    @property
    def num_retained(self) -> int:
        return len(self._retained)

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def page_bytes(self) -> int:
        """Device bytes one page slot occupies across all layers (k + v,
        with the int8 pages' per-token f32 scales), over the model's kv
        heads, as the reference counts it (a rank of a head-sharded pool
        holds its share)."""
        per = self.n_kv_heads * self.page_size * self.head_dim
        scale = (2 * 4 * self.n_kv_heads * self.page_size
                 if self.quantized else 0)
        return self.n_layers * (2 * per * self.k_pages[0].element_size()
                                + scale)

    def can_reserve(self, n_tokens: int, prompt=None) -> bool:
        """Would :meth:`reserve` succeed? Retained shared pages are about to
        be revived, so they do not count as both shared and free."""
        shared = self.match_prefix(prompt)[1] if prompt is not None else []
        revived = sum(1 for s in shared if self.ref[s] == 0)
        return (self.pages_for(n_tokens) - len(shared)
                <= self.num_free - revived)

    # -- prefix trie -----------------------------------------------------
    def match_prefix(self, tokens) -> Tuple[int, List[int]]:
        """Longest registered full-page prefix of ``tokens`` → (n, slots),
        capped before the final token (a sequence always prefills ≥ 1)."""
        ps = self.page_size
        limit = max(0, (len(tokens) - 1) // ps)
        node, slots = self._prefix_root, []
        for i in range(limit):
            nxt = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if nxt is None:
                break
            slots.append(nxt.slot)
            node = nxt
        return len(slots) * ps, slots

    def register_prefix(self, seq_id: int, tokens) -> int:
        """Index a prefilled prompt's full pages for future sharing; existing
        nodes win. Returns the number of pages newly indexed."""
        ps = self.page_size
        node, table, added = self._prefix_root, self.tables[seq_id], 0
        for i in range(len(tokens) // ps):
            chunk = tuple(tokens[i * ps:(i + 1) * ps])
            nxt = node.children.get(chunk)
            if nxt is None:
                slot = table[i]
                if slot in self._prefix_nodes:       # already indexed elsewhere
                    break
                nxt = _PrefixNode(slot)
                node.children[chunk] = nxt
                self._prefix_nodes[slot] = (node, chunk)
                added += 1
            node = nxt
        return added

    def _prefix_forget(self, slot: int) -> None:
        """Drop a slot's trie entry (it is being freed or rewritten)."""
        loc = self._prefix_nodes.pop(slot, None)
        if loc is None:
            return
        parent, key = loc
        node = parent.children.get(key)
        if node is not None and node.slot == slot:
            del parent.children[key]

    # -- alloc / free ----------------------------------------------------
    def _incref(self, slot: int) -> None:
        if self.ref[slot] <= 0:
            raise RuntimeError(f"incref of free page {slot}")
        self.ref[slot] += 1

    def _share(self, slot: int) -> None:
        """Reference a trie-matched slot, reviving it from the retained LRU."""
        if self.ref[slot] == 0:
            if slot not in self._retained:
                raise RuntimeError(f"sharing non-retained free page {slot}")
            del self._retained[slot]
            self.ref[slot] = 1
        else:
            self.ref[slot] += 1

    def _decref(self, slot: int) -> None:
        if self.ref[slot] <= 0:
            raise RuntimeError(f"double free of page {slot}")
        self.ref[slot] -= 1
        if self.ref[slot] == 0:
            if slot in self._prefix_nodes and self.retain_pages > 0:
                self._retained[slot] = None
                while len(self._retained) > self.retain_pages:
                    self._evict_retained()
            else:
                self._prefix_forget(slot)
                self.free.append(slot)

    def _evict_retained(self) -> None:
        """Evict the least-recently-retained prefix page to the free list."""
        slot, _ = self._retained.popitem(last=False)
        self._prefix_forget(slot)
        self.free.append(slot)

    def _alloc(self) -> int:
        if not self.free:
            self._evict_retained()     # LRU-first under pool pressure
        slot = self.free.pop()
        self.ref[slot] = 1
        return slot

    def reserve(self, seq_id: int, n_tokens: int, prompt=None) -> int:
        """Claim pages covering ``n_tokens`` for a new sequence, sharing the
        trie-matched prefix pages of ``prompt``. Returns the prompt tokens
        already covered by shared pages (``lens[seq_id]`` starts there)."""
        if seq_id in self.tables:
            raise ValueError(f"seq {seq_id} already resident")
        matched, shared = (0, [])
        if prompt is not None:
            matched, shared = self.match_prefix(prompt)
        for slot in shared:             # before allocation can evict them
            self._share(slot)
        need = self.pages_for(n_tokens) - len(shared)
        if need > self.num_free:
            for slot in shared:
                self._decref(slot)
            raise RuntimeError(
                f"page pool exhausted: need {need}, free {self.num_free}")
        self.tables[seq_id] = shared + [self._alloc() for _ in range(need)]
        self.lens[seq_id] = matched
        return matched

    def release(self, seq_id: int) -> None:
        """Drop a sequence's page references (retention rules apply)."""
        for slot in self.tables.pop(seq_id):
            self._decref(slot)
        self.lens.pop(seq_id)

    def fork(self, parent_id: int, child_id: int) -> None:
        """O(1) copy-on-write clone: the child shares every parent page."""
        if child_id in self.tables:
            raise ValueError(f"seq {child_id} already resident")
        table = self.tables[parent_id]
        for slot in table:
            self._incref(slot)
        self.tables[child_id] = list(table)
        self.lens[child_id] = self.lens[parent_id]

    def truncate(self, seq_id: int, n_tokens: int, *,
                 drop_unused_pages: bool = False) -> None:
        """Rewind ``seq_id`` to its first ``n_tokens`` tokens (metadata
        only); ``drop_unused_pages`` also decrefs the table's unneeded tail."""
        if not 0 <= n_tokens <= self.lens[seq_id]:
            raise ValueError(
                f"truncate({seq_id}, {n_tokens}): cached {self.lens[seq_id]}")
        self.lens[seq_id] = n_tokens
        if drop_unused_pages:
            keep = self.pages_for(n_tokens)
            table = self.tables[seq_id]
            for slot in table[keep:]:
                self._decref(slot)
            del table[keep:]

    def ensure_writable(self, seq_id: int, page_idx: int) -> int:
        """COW barrier: make ``tables[seq_id][page_idx]`` exclusively owned,
        copying a shared page (all layers, k + v + any scales) to a fresh
        slot."""
        slot = self.tables[seq_id][page_idx]
        if self.ref[slot] == 1:
            self._prefix_forget(slot)
            return slot
        if not self.free and not self._retained:
            raise RuntimeError("page pool exhausted during copy-on-write")
        new = self._alloc()
        for arrs in (self.k_pages, self.v_pages, self.k_scale, self.v_scale):
            for layer in range(self.n_layers):
                if arrs[layer] is not None:
                    arrs[layer][new] = arrs[layer][slot]
        self.ref[slot] -= 1                    # was > 1: never reaches zero
        self.tables[seq_id][page_idx] = new
        return new

    # -- diagnostics -----------------------------------------------------
    def shared_page_stats(self) -> Dict[str, int]:
        """Block-table occupancy: logical entries vs distinct physical slots."""
        entries = sum(len(t) for t in self.tables.values())
        counts: Dict[int, int] = {}
        for table in self.tables.values():
            for slot in table:
                counts[slot] = counts.get(slot, 0) + 1
        shared = sum(1 for c in counts.values() if c > 1)
        return {"table_entries": entries, "distinct_slots": len(counts),
                "shared_slots": shared}

    def check_invariants(self) -> None:
        """Allocator soundness: no leaked or double-freed slots, refcounts
        equal table references, retained slots unreferenced but indexed."""
        assert len(self.free) == len(set(self.free)), "duplicate free slots"
        counts: Dict[int, int] = {}
        for table in self.tables.values():
            for slot in table:
                counts[slot] = counts.get(slot, 0) + 1
        for slot in range(self.num_pages):
            assert self.ref[slot] == counts.get(slot, 0), (
                f"slot {slot}: ref {self.ref[slot]} != "
                f"{counts.get(slot, 0)} table refs")
        assert (len(self.free) + len(self._retained) + len(counts)
                == self.num_pages), "slot leak"
        assert len(self._retained) <= self.retain_pages or \
            self.retain_pages == 0, "retained LRU over capacity"
        for slot in self.free:
            assert self.ref[slot] == 0
            assert slot not in self._retained, f"slot {slot} free+retained"
        for slot in self._retained:
            assert self.ref[slot] == 0, f"retained slot {slot} referenced"
            assert slot in self._prefix_nodes, \
                f"retained slot {slot} not in trie"
        for slot in self._prefix_nodes:
            assert self.ref[slot] > 0 or slot in self._retained, \
                f"trie references free slot {slot}"

    # -- data movement ---------------------------------------------------
    def ingest(self, seq_id: int, layer: int, k_t: torch.Tensor,
               v_t: torch.Tensor, start: int = 0) -> None:
        """Store one layer's KV (1, KV, S, hd) into pages [start, start+S),
        quantized or in the page dtype; ``start`` page-aligned, the written
        pages exclusively owned."""
        ps = self.page_size
        if start % ps:
            raise ValueError(f"ingest start {start} not page-aligned")
        s = k_t.shape[2]
        p0 = start // ps
        n_pages = self.pages_for(s)
        if p0 + n_pages > len(self.tables[seq_id]):
            raise RuntimeError(f"seq {seq_id}: prefill exceeds reservation")
        table = self.tables[seq_id][p0:p0 + n_pages]
        for slot in table:
            if self.ref[slot] > 1:
                raise RuntimeError(f"ingest would write shared page {slot}")
        slots = torch.tensor(table, dtype=torch.long, device=self.device)
        for pages, scales, x in ((self.k_pages, self.k_scale, k_t),
                                 (self.v_pages, self.v_scale, v_t)):
            xp = _chunk_to_pages(x, n_pages, ps)
            if self.quantized:
                xq, sc = _quantize_page_block(xp)
                scales[layer][slots] = sc
            else:
                xq = xp.to(pages[layer].dtype)
            pages[layer][slots] = xq
        self.lens[seq_id] = start + s

    def batch_tables(self, seq_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """Padded (B, max_pages) int32 block table + (B,) int32 lengths."""
        max_pages = max(len(self.tables[s]) for s in seq_ids)
        rows = [self.tables[s] + [0] * (max_pages - len(self.tables[s]))
                for s in seq_ids]
        return (torch.tensor(rows, dtype=torch.int32, device=self.device),
                torch.tensor([self.lens[s] for s in seq_ids],
                             dtype=torch.int32, device=self.device))

    def layer_cache(self, layer: int, tables: torch.Tensor,
                    lengths: torch.Tensor) -> PagedDecodeCache:
        return PagedDecodeCache(
            k_pages=self.k_pages[layer], v_pages=self.v_pages[layer],
            k_scale=self.k_scale[layer], v_scale=self.v_scale[layer],
            tables=tables, lengths=lengths)

    def prefill_cache(self, layer: int, seq_id: int, q_start: int,
                      pages_per_step: int = 1) -> PagedPrefillCache:
        """One layer's view for one sequence's prefill chunk at ``q_start``."""
        return PagedPrefillCache(
            k_pages=self.k_pages[layer], v_pages=self.v_pages[layer],
            k_scale=self.k_scale[layer], v_scale=self.v_scale[layer],
            table=torch.tensor(self.tables[seq_id], dtype=torch.int32,
                               device=self.device),
            q_start=q_start, pages_per_step=pages_per_step)

    def writeback(self, layer: int, cache) -> None:
        """Bind a step's view tensors to the pool. The views update the
        pool's tensors in place, so this re-binds the same objects; it keeps
        the reference's call sites and holds should a view ever copy."""
        self.k_pages[layer] = cache.k_pages
        self.v_pages[layer] = cache.v_pages
        self.k_scale[layer] = cache.k_scale
        self.v_scale[layer] = cache.v_scale
