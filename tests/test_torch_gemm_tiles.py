"""A CPU model of the arithmetic of K5's, K6a's and K6b's tensor-core
kernel (``src/repro_torch/csrc/camp_gemm_tc.cuh``), held exactly against
the jitted reference (``repro.kernels.ops.gemm_i8`` / ``gemm_w4`` /
``gemm_a4w4`` with ``impl='xla'`` under ``jax.jit``, as
``tests/test_torch_unfused.py`` runs it).

The kernel cannot run here, so this model does, in PyTorch, what it does on
the card, in its order:

* the split plan (``kernels/camp_gemm.py::split_plan``): row tile MT, and
  the K steps of 128 bytes split into runs of ``per``;
* each K step's tiles as TMA (or the byte gathers) leave them in shared
  memory: A's MT rows and B's rows as stored (K5: 128 k rows; K6a, K6b: 64
  packed rows) of 128 columns, zero-filled past M, N and K, each byte at
  the address of the 128-byte swizzle (``swz_off``);
* K6b's packed A instead: each thread's 16-byte groups (32 k of a row,
  zero past M and K/2) unpacked by the kernel's ``__byte_perm`` selectors
  and nibble sign extension into two 16-byte int8 chunks, stored at
  ``swz_off``;
* B rewritten K-major by the kernel's threads: each lane's 4 k x 4 n block
  read as words from the staging tile, turned into 4 words of 4
  consecutive k by the kernel's ``__byte_perm`` selectors (K5) or its
  nibble unpack (K6a), and stored at ``swz_off``;
* the wgmma operands read back through the descriptor's view (start
  address + 32 bytes a k32 step, 128 bytes a row, 1024 an 8-row group,
  then the hardware's 128-byte swizzle of the address), which must give
  every (row, k) its byte: A as it is (K6b: unpacked), B transposed;
* int32 partial sums per split, one plane each, summed across splits in
  split order by the flush kernel, then the flush
  (``kernels/ref.py::flush_ref``, the plain version's, which phase 2 of
  ``chip_smoke.py`` holds the kernel's flush to).

The model's output must equal the reference bit for bit at the six serving
shapes and at ragged ones; a control that leaves one split's partial sums
out must not.
"""
import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.blocking import (TC_BK, TC_BN,  # noqa: E402
                                       TC_ROW_TILES, split_plan)
from repro_torch.kernels.ref import flush_ref  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

SMS = 132                # the H100's SMs
BN, BK = TC_BN, TC_BK    # output columns a block; K bytes a step
# kernel → (B packed int4, A packed int4)
KINDS = {"k5": (False, False), "k6a": (True, False), "k6b": (True, True)}
SERVING_SHAPES = ((8, 896, 4864), (8, 896, 896), (8, 896, 128),
                  (8, 4864, 896), (256, 896, 4864), (256, 4864, 896))
RAGGED_SHAPES = ((1, 928, 200), (3, 4870, 200), (17, 928, 200),
                 (100, 4870, 200), (100, 4880, 208))
# the epilogue each serving shape carries on the model path (chip_smoke.py);
# silu is held within one ULP on the card, so the exact model takes none
EPILOGUE = {(8, 896, 128): "bias"}


# -- the kernel's shared-memory addressing ----------------------------------
def swz_off(r, c):
    """The writer's address of byte c of row r of a tile with 128-byte rows
    (A's tiles, B's staging tiles, B^T): the 128-byte swizzle as TMA writes
    it."""
    return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)


def desc_view(rows):
    """(rows, 128) addresses that wgmma reads for (row, k byte) of a K-major
    tile through its descriptors: start = tile + 32 bytes a k32 step, row r
    at (r % 8) * 128 + (r // 8) * 1024 (the stride offset), then the
    128-byte swizzle of the address (bits 4-6 ^= bits 7-9)."""
    r = torch.arange(rows)[:, None]
    kb = torch.arange(128)[None, :]
    addr = (kb // 32) * 32 + (r % 8) * 128 + (r // 8) * 1024 + kb % 32
    return addr ^ (((addr >> 7) & 7) << 4)


def threads(w4):
    """Per (round, warp, lane): the k-quad q, n-quad p (``n_quad``) and the
    first column ``rot`` of the lane's block in ``convert_b``."""
    i, w, l = torch.meshgrid(torch.arange(4), torch.arange(8),
                             torch.arange(32), indexing="ij")
    x = 8 * i + w
    q = 4 * (x & 7) + (l & 3)
    if w4:
        hi = 2 * (x >> 3) + (l >> 4)
    else:
        hi = 4 * ((x >> 3) & 1) + ((((l >> 1) & 1) ^ (x >> 4)) + 2 * (l >> 4))
    return q, 4 * hi + ((l >> 2) & 3), (l >> 3) & 3


def byte_perm(x, y, s):
    """CUDA's __byte_perm on int64 tensors of 32-bit values: byte n of the
    result is byte (s >> 4n) & 7 of y:x."""
    out = torch.zeros_like(x)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        src = torch.where(sel < 4, x, y)
        out |= ((src >> (8 * (sel & 3))) & 0xFF) << (8 * n)
    return out


def column_i8(w, c):
    sel = c | ((c + 4) << 4)
    return byte_perm(byte_perm(w[0], w[1], sel), byte_perm(w[2], w[3], sel),
                     torch.full_like(c, 0x5410))


def sext_nibbles(t):
    """The nibbles of t that its bytes' positions pick (low in bytes 0 and
    2, high in 1 and 3), each sign-extended to its byte."""
    u = (t & 0xF000F000) | ((t << 4) & 0x00F000F0)
    return ((u >> 4) & 0x0F0F0F0F) | (((u >> 7) & 0x01010101) * 0xF0)


def column_w4(w, c):
    return sext_nibbles(
        byte_perm(w[0], w[1], c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)))


def words(img, addr):
    """Little-endian 32-bit words of the byte images ``img`` (T, bytes) at
    byte addresses ``addr`` (any shape, multiples of 4)."""
    b = img[:, addr.reshape(-1)[:, None] + torch.arange(4)]
    w = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24))
    return w.reshape(img.shape[0], *addr.shape)


def scatter(tiles, offsets, size):
    """Shared-memory images (T, size) of tiles (T, rows, 128) written at the
    writer's ``offsets`` (rows, 128); every byte at its own address."""
    flat = offsets.reshape(-1)
    assert flat.unique().numel() == flat.numel() == tiles[0].numel()
    img = torch.full((tiles.shape[0], size), -1, dtype=torch.int64)
    img[:, flat] = tiles.reshape(tiles.shape[0], -1)
    return img


def convert_b(raw, w4):
    """B's staging images (T, rows * 128) → B^T images (T, 128 * 128), by
    the kernel's threads."""
    rpq = 2 if w4 else 4
    q, p, rot = threads(w4)
    w = [words(raw, swz_off(rpq * q + r, 4 * p)) for r in range(rpq)]
    bt = torch.full((raw.shape[0], BN * BK), -1, dtype=torch.int64)
    stores = []
    for j in range(4):
        c = (j + rot) & 3
        v = column_w4(w, c) if w4 else column_i8(w, c)
        addr = swz_off(4 * p + c, 4 * q)
        stores.append(addr)
        for e in range(4):
            bt[:, (addr + e).reshape(-1)] = ((v >> (8 * e)) & 0xFF).reshape(
                raw.shape[0], -1)
    stores = torch.stack(stores).reshape(-1)
    assert stores.unique().numel() == stores.numel() == BN * BK // 4
    return bt


def as_int8(x):
    return ((x & 0xFF) ^ 0x80) - 0x80


def store_a4(packed, mt):
    """K6b's A slot images (T, mt * 128) from packed A's step tiles
    (T, mt, 64 bytes, zero past M and K/2), as the kernel's threads store
    them: group g (thread g % 256, its j = g / 256) is row g / 4, packed bytes 16 (g % 4)
    on; each of its words (8 k) becomes two int8 words (k 0-3 and 4-7 of
    the word), the group's 32 k two 16-byte chunks at swz_off(row, 32 (g %
    4)) and 16 bytes on."""
    g = torch.arange(mt * 4)
    r, col = g // 4, 16 * (g % 4)
    w = words(packed.reshape(packed.shape[0], -1),
              (r * 64 + col)[:, None] + 4 * torch.arange(4))
    out = []
    for sel in (0x1100, 0x3322):
        out.append(sext_nibbles(byte_perm(w, torch.zeros_like(w),
                                          torch.full_like(w, sel))))
    # word i of the 8: packed word i // 2, low (0x1100) or high half
    out = torch.stack(out, -1).reshape(*w.shape[:2], 8)
    img = torch.full((packed.shape[0], mt * BK), -1, dtype=torch.int64)
    stores = []
    for half in range(2):
        for i in range(4):
            addr = swz_off(r, 2 * col + 16 * half + 4 * i)
            stores.append(addr)
            v = out[:, :, 4 * half + i]
            for e in range(4):
                img[:, addr + e] = (v >> (8 * e)) & 0xFF
    stores = torch.stack(stores).reshape(-1)
    assert stores.unique().numel() == stores.numel() == mt * BK // 4
    return img


def model(a, b, m, k, n, w4, plan=None, a4=False):
    """The kernel's int32 sums (M, N) for a (M, K) int8 or (M, K/2) packed
    (``a4``) and b (K, N) int8 or (K/2, N) packed, under ``plan`` (default:
    split_plan's)."""
    mt, splits, per = plan or split_plan(m, n, k, SMS)
    steps = -(-k // BK)
    rows_b = BK // 2 if w4 else BK
    mtiles, ntiles = -(-m // mt), -(-n // BN)
    # what cp.async leaves in shared memory: tiles zero-filled past M, N, K
    ap = torch.zeros(mtiles * mt, steps * BK, dtype=torch.int64)
    ap[:m, :k] = (unpacked(a.T, k, True).T if a4 else a).long() & 0xFF
    bp = torch.zeros(steps * rows_b, ntiles * BN, dtype=torch.int64)
    bp[:b.shape[0], :n] = b.long() & 0xFF
    a_tiles = ap.reshape(mtiles, mt, steps, BK).permute(0, 2, 1, 3)
    b_tiles = bp.reshape(steps, rows_b, ntiles, BN).permute(2, 0, 1, 3)
    r, c = torch.meshgrid(torch.arange(mt), torch.arange(BK), indexing="ij")
    if a4:
        # the registers' packed groups: zero past M and past K/2
        pp = torch.zeros(mtiles * mt, steps * BK // 2, dtype=torch.int64)
        pp[:m, :a.shape[1]] = a.long() & 0xFF
        a_img = store_a4(pp.reshape(mtiles, mt, steps, BK // 2).permute(
            0, 2, 1, 3).reshape(-1, mt, BK // 2), mt)
    else:
        a_img = scatter(a_tiles.reshape(-1, mt, BK), swz_off(r, c), mt * BK)
    r, c = torch.meshgrid(torch.arange(rows_b), torch.arange(BN),
                          indexing="ij")
    raw = scatter(b_tiles.reshape(-1, rows_b, BN), swz_off(r, c),
                  rows_b * BN)
    bt = convert_b(raw, w4)
    # the wgmma operands through the descriptors
    a_op = as_int8(a_img[:, desc_view(mt)]).reshape(mtiles, steps, mt, BK)
    b_op = as_int8(bt[:, desc_view(BN)]).reshape(ntiles, steps, BN, BK)
    assert torch.equal(a_op, as_int8(a_tiles))
    # int32 partials per (n tile, m tile, step), exact in f64; summed per
    # split, then across splits
    prod = torch.einsum("xsnk,ysmk->xysnm", b_op.double(), a_op.double())
    partials = []
    for z in range(splits):
        part = prod[:, :, z * per:(z + 1) * per].sum(2).long()
        assert part.abs().max() < 2 ** 31
        partials.append(part)
    acc = torch.stack(partials).sum(0)
    acc = acc.permute(1, 3, 0, 2).reshape(mtiles * mt, ntiles * BN)
    return acc[:m, :n].to(torch.int32), b_op


def unpacked(b, k, w4):
    if not w4:
        return b
    lo = (b << 4).to(torch.int8) >> 4
    hi = b.to(torch.int8) >> 4
    return torch.stack([lo, hi], 1).reshape(-1, b.shape[1])[:k]


def inputs(m, k, n, kind, seed):
    w4, a4 = KINDS[kind]
    rng = np.random.default_rng(seed)
    a_max = 7 if a4 else 127
    a = rng.integers(-a_max, a_max + 1, (m, k)).astype(np.int8)
    if a4:
        a[0, :3] = -8          # the nibble 0x8, which no quantize emits
        a = np.asarray(jquant.pack_int4(jnp.asarray(a).T).T)
    b_max = 7 if w4 else 127
    b = rng.integers(-b_max, b_max + 1, (k, n)).astype(np.int8)
    if w4:
        b = np.asarray(jquant.pack_int4(jnp.asarray(b)))
    sa = rng.uniform(0.001, 0.05, (m, 1)).astype(np.float32)
    sb = rng.uniform(0.001, 0.05, (1, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return a, b, sa, sb, bias


def reference(a, b, sa, sb, bias, kind, epilogue, k):
    jb = jnp.asarray(bias, jnp.bfloat16) if epilogue == "bias" else None
    kw = dict(impl="xla", out_dtype=jnp.bfloat16, epilogue=epilogue)
    if kind == "k6b":
        run = jax.jit(lambda a, b, sa, sb, bias: jops.gemm_a4w4(
            a, b, k, sa, sb, bias=bias, **kw))
    else:
        fn = jops.gemm_w4 if kind == "k6a" else jops.gemm_i8
        run = jax.jit(lambda a, b, sa, sb, bias: fn(a, b, sa, sb, bias=bias,
                                                    **kw))
    return to_numpy(run(a, b, sa, sb, jb))


def flushed(acc, sa, sb, bias, epilogue):
    tb = (torch.from_numpy(bias).to(torch.bfloat16)
          if epilogue == "bias" else None)
    return to_numpy(flush_ref(acc, torch.from_numpy(sa), torch.from_numpy(sb),
                              out_dtype=torch.bfloat16, epilogue=epilogue,
                              bias=tb))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", SERVING_SHAPES + RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_model_equals_jitted_reference(shape, kind):
    m, k, n = shape
    w4, a4 = KINDS[kind]
    a, b, sa, sb, bias = inputs(m, k, n, kind, seed=m + k + n + w4 + a4)
    acc, b_op = model(torch.from_numpy(a), torch.from_numpy(b), m, k, n, w4,
                      a4=a4)
    # B^T as wgmma reads it: B transposed, unpacked, zero past K
    want_b = torch.zeros(b_op.shape[0] * BN, b_op.shape[1] * BK,
                         dtype=torch.int64)
    want_b[:n, :k] = unpacked(torch.from_numpy(b), k, w4).T.long()
    got_b = b_op.permute(0, 2, 1, 3).reshape(want_b.shape)
    assert torch.equal(got_b, want_b)
    a_q = torch.from_numpy(a)
    if a4:
        a_q = unpacked(a_q.T, k, True).T
    exact = a_q.double() @ unpacked(torch.from_numpy(b), k, w4).double()
    assert torch.equal(acc, exact.to(torch.int32))
    epi = EPILOGUE.get(shape, "none")
    np.testing.assert_array_equal(flushed(acc, sa, sb, bias, epi),
                                  reference(a, b, sa, sb, bias, kind, epi, k))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", [(256, 4864, 896), (8, 4864, 896)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dropped_split_control_fails(shape, kind):
    """The same model with its last split left out (splits - 1 runs of the
    plan's length, as chip_smoke's control launches the kernel) misses
    the reference."""
    m, k, n = shape
    w4, a4 = KINDS[kind]
    mt, splits, per = split_plan(m, n, k, SMS)
    assert splits > 1
    a, b, sa, sb, bias = inputs(m, k, n, kind, seed=7)
    acc, _ = model(torch.from_numpy(a), torch.from_numpy(b), m, k, n, w4,
                   plan=(mt, splits - 1, per), a4=a4)
    got = flushed(acc, sa, sb, bias, "none")
    want = reference(a, b, sa, sb, bias, kind, "none", k)
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("shape", SERVING_SHAPES + RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_split_plan(shape):
    """Every K step in exactly one split, no split empty, and about one
    block an SM: at most SMS blocks unless one split a tile already
    exceeds it, and more than SMS / 2 where K has the steps for it."""
    m, k, n = shape
    mt, splits, per = split_plan(m, n, k, SMS)
    assert mt == min(t for t in TC_ROW_TILES if t >= min(m, TC_ROW_TILES[-1]))
    steps = -(-k // BK)
    assert (splits - 1) * per < steps <= splits * per
    tiles = -(-n // BN) * -(-m // mt)
    blocks = tiles * splits
    assert blocks <= max(SMS, tiles)
    if steps >= SMS // tiles * 2:
        assert blocks > SMS // 2


@pytest.mark.parametrize("w4", [False, True], ids=["k5", "k6a"])
def test_conversion_is_bank_conflict_free(w4):
    """In ``convert_b`` the 32 lanes of a warp read and write 32 distinct
    banks (4-byte words, 32 banks) at every step."""
    q, p, rot = threads(w4)
    rpq = 2 if w4 else 4
    for r in range(rpq):
        banks = (swz_off(rpq * q + r, 4 * p) // 4) % 32
        assert (banks.sort(-1).values == torch.arange(32)).all()
    for j in range(4):
        c = (j + rot) & 3
        banks = (swz_off(4 * p + c, 4 * q) // 4) % 32
        assert (banks.sort(-1).values == torch.arange(32)).all()


@pytest.mark.parametrize("mt", TC_ROW_TILES)
def test_descriptor_view_is_the_writers_layout(mt):
    """The address wgmma reads for (row, k byte) is the one the kernel
    wrote it to, for every row tile and for B^T's 128 rows."""
    for rows in (mt, BN):
        r, c = torch.meshgrid(torch.arange(rows), torch.arange(BK),
                              indexing="ij")
        assert torch.equal(desc_view(rows), swz_off(r, c))


@pytest.mark.parametrize("op", ["IGMMA", "IDP4A"])
def test_sass_patterns_match_literal_lines(op):
    """chip_smoke.py's SASS patterns, which phase 1 counts in the GEMM
    libraries (an IGMMA in every tensor-core instance, no IDP.4A anywhere):
    each matches its literal line of cuobjdump output and no other pattern
    does, so a count of 0 means the instruction is absent."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    line = chip_smoke.SASS_LINES[op]
    assert re.search(chip_smoke.SASS_OPS[op], line)
    assert not re.search(chip_smoke.SASS_OPS[op], line.replace(
        "IGMMA" if op == "IGMMA" else "IDP.4A", "IMAD"))
    chip_smoke.sass_patterns_match()
