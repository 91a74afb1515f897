"""A CPU model of K7, the rowwise quantize kernel
(``src/repro_torch/csrc/quantize.cu``), held bit for bit against the jitted
reference (``repro.kernels.ops.quantize_rowwise`` with ``impl='xla'`` under
``jax.jit``) and the interpret-mode Pallas kernel.

The kernel cannot run here, so this model does, in numpy's float32, what it
does on the card, in its order:

* the row partition (``kernels/quantize.py::team_size``): a team of
  ``team`` threads a row, several rows a block of 256 threads or a cluster
  of up to 8 blocks a row; thread t of the team takes the 16-byte groups
  t, t + team, ... of its row (8 bf16 or 4 f32 values, zero past K), the
  first 4 of them in registers, any others read again for the quantize;
* the absmax as the kernel reduces it: each thread's maximum over its
  groups, then over the team (warp shuffles, the block's warps, the
  cluster's blocks); the scale ``absmax * f32(1/qmax)`` (1 where it is 0)
  and its reciprocal rounded to f32;
* each group quantized from the same values by the template's rounding
  (``test_torch_fused_tiles.quantize_groups``: the exact product with the
  reciprocal rounded by an fma with 1.5 * 2^23, the division for groups
  near a half-integer), and stored as a word (8 bytes bf16, 4 f32) or, in
  rows that are not 16-byte aligned, byte by byte up to K.

It must equal the reference at M 1, 8 and 256, K 17, 896, 4,870 and 4,864,
bits 8 and 4, bf16 and f32, with zero rows and with values whose quotients
are half-integers or a few ULPs from one.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels.quantize import (BLOCK, GROUPS_A_THREAD,  # noqa: E402
                                          MAX_TEAM, REG_GROUPS, team_size)
from repro_torch.kernels.ref import recip_f32  # noqa: E402
from test_torch_fused_tiles import quantize_groups  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

SMS = 132                # the H100's SMs
DTYPES = {"bfloat16": (jnp.bfloat16, 2), "float32": (jnp.float32, 4)}
SHAPES = [(m, k) for m in (1, 8, 256) for k in (17, 896, 4870, 4864)]


def partition(m, k, xb, team):
    """(block, thread in the block, register slot or -1) of every group of
    every row, (M, groups) each, with the launch's blocks and cluster size;
    every group owned by exactly one thread of its row's team."""
    groups = -(-k // (16 // xb))
    assert team in [32 << i for i in range(7)] and team <= MAX_TEAM
    cluster = max(1, team // BLOCK)
    rows = max(1, BLOCK // team)               # rows a block
    n_blocks = -(-m // rows) if team < BLOCK else m * cluster
    assert n_blocks % cluster == 0 and cluster <= 8
    g = np.arange(groups)
    t, j = g % team, g // team                 # the team's thread, its slot
    r = np.arange(m)[:, None]
    if team < BLOCK:
        block = np.broadcast_to(r // rows, (m, groups))
        thread = (r % rows) * team + t
    else:
        block = r * cluster + t // BLOCK
        thread = np.broadcast_to(t % BLOCK, (m, groups))
    block = np.broadcast_to(block, (m, groups))
    thread = np.broadcast_to(thread, (m, groups))
    assert (block < n_blocks).all() and (thread < BLOCK).all()
    # a thread works for one row only
    owner = block * BLOCK + thread
    pairs = np.unique(np.stack([owner.ravel(),
                                np.broadcast_to(r, owner.shape).ravel()]),
                      axis=1)
    assert pairs.shape[1] == np.unique(owner).size
    slot = np.broadcast_to(np.where(j < REG_GROUPS, j, -1), (m, groups))
    return block, thread, slot, n_blocks, cluster


def k7_model(x32, qmax, xb, team):
    """(q int8 (M, K), s f32 (M, 1), groups that took the division) as the
    kernel computes them."""
    m, k = x32.shape
    kpg = 16 // xb
    groups = -(-k // kpg)
    block, thread, slot, n_blocks, cluster = partition(m, k, xb, team)
    v = np.zeros((m, groups * kpg), np.float32)
    v[:, :k] = x32
    v = v.reshape(m, groups, kpg)
    # each thread's maximum over its groups, then the team's: by block and
    # thread, whatever the order (max is exact)
    per_group = np.abs(v).max(axis=2, initial=np.float32(0))
    amax = np.zeros(m, np.float32)
    for r in range(m):
        owners = block[r] * BLOCK + thread[r]
        for o in np.unique(owners):
            amax[r] = max(amax[r], per_group[r, owners == o].max())
    s = np.where(amax == 0, np.float32(1),
                 amax * np.float32(recip_f32(qmax))).astype(np.float32)
    with np.errstate(divide="ignore", over="ignore"):
        rcp = (np.float32(1) / s).astype(np.float32)
    q, slow = quantize_groups(v, s, rcp, qmax)
    # the stores: whole words where the rows are 16-byte aligned, else
    # bytes up to K (nothing past it)
    out = np.zeros((m, k), np.int8)
    written = np.zeros((m, k), np.int64)
    flat = q.reshape(m, groups * kpg)
    if k * xb % 16 == 0:
        out[:, :] = flat
        written += 1
    else:
        for e in range(kpg):
            cols = np.arange(groups) * kpg + e
            cols = cols[cols < k]
            out[:, cols] = flat[:, cols]
            written[:, cols] += 1
    assert (written == 1).all()
    return out, s[:, None], slow


def inputs(m, k, dt, seed, qmax):
    """x (M, K) in dt (a zero row where M > 1) with some rows whose
    quotients x / s are half-integers (exact in bf16 and f32: the absmax
    is qmax · 2^e, so s is 2^e to within an ULP) or, in f32, a few ULPs
    from one."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k))
         * rng.uniform(0.01, 100.0, (m, 1))).astype(np.float32)
    if m > 1:
        x[m // 2] = 0.0
    for r in range(0, m, 3):
        if m > 1 and r == m // 2:
            continue
        e = np.float32(2.0 ** rng.integers(-8, 8))
        half = rng.integers(-qmax, qmax, k) + 0.5
        x[r] = (half * e).astype(np.float32)
        x[r, 0] = qmax * e                    # the absmax
        if dt == "float32" and r % 2:
            bits = x[r].view(np.int32) + rng.integers(-3, 4, k).astype(
                np.int32)
            x[r, 1:] = np.clip(bits.view(np.float32)[1:], -qmax * e,
                               qmax * e)
    return jnp.asarray(x, DTYPES[dt][0])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k7_model_equals_references(shape, bits, dt):
    m, k = shape
    qmax = 127 if bits == 8 else 7
    jx = inputs(m, k, dt, seed=m + k + bits, qmax=qmax)
    x32 = to_numpy(jx).astype(np.float32)
    xb = DTYPES[dt][1]
    q, s, slow = k7_model(x32, qmax, xb, team_size(m, k, xb, SMS))
    if m > 2:
        assert slow > 0                       # the ties took the division
    for want_q, want_s in (
            jax.jit(functools.partial(jops.quantize_rowwise, bits=bits,
                                      impl="xla"))(jx),
            jops.quantize_rowwise(jx, bits=bits, impl="pallas")):
        np.testing.assert_array_equal(q, np.asarray(want_q))
        np.testing.assert_array_equal(s, np.asarray(want_s))
    if m > 1:
        assert (q[m // 2] == 0).all() and s[m // 2, 0] == 1


@pytest.mark.parametrize("xb", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 256, 4096])
@pytest.mark.parametrize("k", [17, 896, 4864, 4870, 29568, 200000])
def test_team_size(m, k, xb):
    """A power of two from 32 to a cluster of 8 blocks; each thread holds at
    most GROUPS_A_THREAD groups unless the row needs the largest team; a
    cluster only where a block's threads would hold more groups than their
    registers; the team is the smallest that meets these, or twice one
    that leaves SMs idle."""
    team = team_size(m, k, xb, SMS)
    groups = -(-k * xb // 16)
    assert team in [32 << i for i in range(7)] and team <= MAX_TEAM
    assert team * GROUPS_A_THREAD >= groups or team == MAX_TEAM
    if team > BLOCK:
        assert team // 2 * REG_GROUPS < groups
    if team > 32:
        half = team // 2
        assert (half * GROUPS_A_THREAD < groups
                or (-(-m * half // BLOCK) < SMS and half < groups))
