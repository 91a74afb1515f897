"""A CPU model of the arithmetic of the K2/K3 kernels
(``src/repro_torch/csrc/paged_common.cuh``), held against the reference's
jitted ``paged_attention_reference`` / ``paged_prefill_reference``.

The kernels cannot run here, so this model does, in PyTorch, what they do
on the card.

* bf16 q: int8 K and V exact in bf16; q in one bf16 part and w = p * vs in
  three (each the bf16 rounding of what the earlier ones left), each part's
  products summed in f32 and the parts added smallest first; the
  per-token scales applied outside the products (``((q . k) * ks) *
  sm_scale``); 64-token kv tiles walked by blocks of up to 64 query rows,
  each stopping at the causal bound of its last row; an online softmax
  (masked scores -1e30); the kv tiles cut into the wrapper's splits
  (``split_plan``) whose partials (m, l, acc) are merged in log-sum-exp
  form, the final division by max(l, 1e-30).
* f32 q: the plain version's order of operations in f32 (scores against
  k * ks, the softmax normalised, then its product with v * vs), one block
  per head. On the card the kernel forms each sum as the plain version's
  einsum does there (a fused multiply-add chain in index order); here the
  order is the CPU's.

Tolerances are ``chip_smoke.py``'s for the kernels against their plain
versions: f32 q, atol = rtol = 1e-5; bf16 q, one bf16 ULP of the larger
magnitude + 1e-5. A control shows that w in one bf16 part misses the bf16
bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import \
    paged_attention_reference as jpa_ref  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_reference as jpp_ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

ATT_TOL = 1e-5
BF16_ULP_REL = 2.0 ** -7
H100_SMS = 132
NEG = -1e30
PARTS = (1, 3)     # bf16 q: q in one bf16 part, w = p * vs in three


def split(x, n):
    """x (f32) as n bf16-valued f32 tensors, each the bf16 rounding of what
    the earlier ones left."""
    parts = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def product(x, n, b):
    """x @ b with x in n bf16 parts: each part's products summed in f32,
    the parts added smallest first."""
    out = None
    for p in reversed(split(x, n)):
        y = p @ b
        out = y if out is None else out + y
    return out


def walk(q, k, v, ks, vs, lim, tiles, sm_scale, parts):
    """Online softmax of rows with visible columns <= lim over the given
    64-token tiles of k, v (int8 values as f32), ks, vs → (m, l, acc)."""
    r, hd = q.shape
    m = torch.full((r,), NEG)
    l = torch.zeros(r)
    acc = torch.zeros(r, hd)
    for j in tiles:
        c0, c1 = j * pa.TILE, min(k.shape[0], (j + 1) * pa.TILE)
        cols = torch.arange(c0, c1)
        s = product(q, parts[0], k[c0:c1].T)
        s = (s * ks[c0:c1]) * sm_scale
        s = torch.where(cols[None, :] <= lim[:, None], s, torch.tensor(NEG))
        mn = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn[:, None])
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + product(p * vs[c0:c1], parts[1],
                                            v[c0:c1])
        m = mn
    return m, l, acc


def model_head(q, k, v, ks, vs, pos0, g, plan, parts, sm_scale):
    """The bf16 kernels on one (sequence, kv head): q (R, hd) f32, R = C * G
    query rows at positions pos0 + r // G; k, v (T, hd), ks, vs (T,) the
    head's gathered columns (T >= the causal bound)."""
    rows, hd = q.shape
    n_split, per = plan
    rpb = pa.rows_per_block(rows)
    out = torch.empty(rows, hd)
    for r0 in range(0, rows, rpb):
        r1 = min(rows, r0 + rpb)
        lim = pos0 + torch.arange(r0, r1) // g
        n_tiles = -(-(int(lim[-1]) + 1) // pa.TILE)
        partials = []
        for z in range(n_split):
            tiles = range(z * per, min(n_tiles, (z + 1) * per))
            if len(tiles) == 0:            # a split past the bound
                partials.append((torch.full((r1 - r0,), NEG),
                              torch.zeros(r1 - r0),
                              torch.zeros(r1 - r0, hd)))
            else:
                partials.append(walk(q[r0:r1], k, v, ks, vs, lim, tiles,
                                     sm_scale, parts))
        if n_split == 1:
            m, l, acc = partials[0]
            out[r0:r1] = acc / torch.clamp(l, min=1e-30)[:, None]
            continue
        mx = torch.stack([p[0] for p in partials]).max(dim=0).values
        w = [torch.exp(p[0] - mx) for p in partials]
        l = sum(wi * p[1] for wi, p in zip(w, partials))
        acc = sum(wi[:, None] * p[2] for wi, p in zip(w, partials))
        out[r0:r1] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def model_head_f32(q, k, v, ks, vs, pos0, g, sm_scale):
    """The f32 kernels on one (sequence, kv head), in the plain version's
    order of operations: scores of q against k * ks in f32, times sm_scale,
    masked; the softmax normalised; then its product with v * vs."""
    lim = pos0 + torch.arange(q.shape[0]) // g
    s = (q @ (k * ks[:, None]).T) * sm_scale
    s = torch.where(torch.arange(k.shape[0])[None, :] <= lim[:, None], s,
                    torch.tensor(NEG))
    return torch.softmax(s, dim=1) @ (v * vs[:, None])


def gather(pages, scales, table, h, n):
    """Columns 0 .. n - 1 of kv head h through the block table."""
    ps = pages.shape[2]
    cols = torch.arange(n)
    slots = table[cols // ps].long()
    return pages[slots, h, cols % ps].float(), scales[slots, h, cols % ps]


def model_decode(q, kp, vp, ks, vs, tables, lengths, parts=PARTS, plan=None):
    b, kv, g, hd = q.shape
    if plan is None:
        max_tiles = -(-tables.shape[1] * kp.shape[2] // pa.TILE)
        plan = pa.split_plan(b * kv * -(-g // pa.rows_per_block(g)),
                             max_tiles, H100_SMS)
    out = torch.empty(b, kv, g, hd)
    for i in range(b):
        n = int(lengths[i])
        for h in range(kv):
            kd, ksd = gather(kp, ks, tables[i], h, n)
            vd, vsd = gather(vp, vs, tables[i], h, n)
            if q.dtype == torch.float32:
                out[i, h] = model_head_f32(q[i, h], kd, vd, ksd, vsd, n - 1,
                                           g, hd ** -0.5)
            else:
                out[i, h] = model_head(q[i, h].float(), kd, vd, ksd, vsd,
                                       n - 1, g, plan, parts, hd ** -0.5)
    return out.to(q.dtype)


def model_prefill(q, kp, vp, ks, vs, table, q_start, parts=PARTS):
    kv, c, g, hd = q.shape
    n = q_start + c
    max_tiles = -(-n // pa.TILE)
    rows = c * g
    plan = pa.split_plan(kv * -(-rows // pa.rows_per_block(rows)), max_tiles,
                         H100_SMS)
    out = torch.empty(kv, rows, hd)
    for h in range(kv):
        kd, ksd = gather(kp, ks, table, h, n)
        vd, vsd = gather(vp, vs, table, h, n)
        qh = q[h].reshape(rows, hd).float()
        if q.dtype == torch.float32:
            out[h] = model_head_f32(qh, kd, vd, ksd, vsd, q_start, g,
                                    hd ** -0.5)
        else:
            out[h] = model_head(qh, kd, vd, ksd, vsd, q_start, g, plan, parts,
                                hd ** -0.5)
    return out.reshape(kv, c, g, hd).to(q.dtype)


def att_ok(got, want, dtype):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return bool(((got - want).abs() <= ATT_TOL + ATT_TOL * want.abs())
                    .all())
    return bool(((got - want).abs() <= ATT_TOL + BF16_ULP_REL
                 * torch.maximum(got.abs(), want.abs())).all())


def pages(rng, num_pages, kv, ps, hd):
    kp = rng.integers(-127, 128, (num_pages, kv, ps, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (num_pages, kv, ps, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 5e-2, (num_pages, kv, ps)).astype(np.float32)
    vs = rng.uniform(1e-3, 5e-2, (num_pages, kv, ps)).astype(np.float32)
    return kp, vp, ks, vs


def to_jax(x, dtype):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dtype == torch.bfloat16 else a


def to_torch(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if t.is_floating_point() and x.ndim == 4 else t


def from_jax(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


SERVING = [1, 16, 17, 100, 255, 512, 529, 544]
# (label, B, KV, G, hd, ps, lengths, n_split (None: the wrapper's plan))
DECODE = [
    ("qwen2-0.5b serving head", 8, 2, 7, 64, 16, SERVING, None),
    ("qwen2-0.5b serving head, ps 8", 8, 2, 7, 64, 8, SERVING, None),
    ("long context", 1, 2, 7, 64, 16, [4096], 16),
    ("hd 128, G 2 (qwen3-0.6b)", 4, 2, 2, 128, 16, [1, 100, 513, 1000],
     None),
    ("hd 160, G 4 (stablelm-12b)", 4, 2, 4, 160, 8, [1, 100, 513, 1000],
     None),
]
DTYPES = [torch.float32, torch.bfloat16]
# (label, KV, G, hd, ps, C, q_start, dtypes)
PREFILL = [
    ("C 256, q_start 0", 2, 7, 64, 16, 256, 0, DTYPES),
    ("C 256, q_start 512", 2, 7, 64, 16, 256, 512, DTYPES),
    ("C 256, q_start 517", 2, 7, 64, 16, 256, 517, DTYPES),
    ("C 256, q_start 517, ps 8", 2, 7, 64, 8, 256, 517, DTYPES),
    ("hd 128, G 2 (qwen3-0.6b)", 2, 2, 128, 16, 64, 300, DTYPES),
    ("hd 160, G 4 (stablelm-12b)", 2, 4, 160, 8, 64, 300, DTYPES),
    ("hd 128, G 8 (qwen2-72b), C 256", 2, 8, 128, 16, 256, 512, DTYPES),
    ("hd 160, G 4 (stablelm-12b), C 256", 2, 4, 160, 16, 256, 512, DTYPES),
]


def decode_case(case, dtype, seed=0):
    _, b, kv, g, hd, ps, lengths, n_split = case
    rng = np.random.default_rng(seed + hd + b)
    max_pages = -(-max(lengths) // ps) + 1
    num_pages = b * max_pages + 8
    kp, vp, ks, vs = pages(rng, num_pages, kv, ps, hd)
    tables = rng.permutation(num_pages)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    want = from_jax(jax.jit(jpa_ref)(to_jax(q, dtype), *map(
        jnp.asarray, (kp, vp, ks, vs, tables, lens))))
    t = [to_torch(x, dtype) for x in (q, kp, vp, ks, vs, tables, lens)]
    plan = None
    if n_split is not None:
        max_tiles = -(-max_pages * ps // pa.TILE)
        per = -(-max_tiles // n_split)
        plan = (-(-max_tiles // per), per)
    return t, want, plan


def prefill_case(case, dtype):
    _, kv, g, hd, ps, c, q_start, _ = case
    rng = np.random.default_rng(kv * 1000 + c + q_start + hd)
    n_pages = -(-(q_start + c) // ps)
    num_pages = n_pages + 16
    kp, vp, ks, vs = pages(rng, num_pages, kv, ps, hd)
    table = rng.permutation(num_pages)[:n_pages + 2].astype(np.int32)
    q = rng.standard_normal((kv, c, g, hd)).astype(np.float32)
    want = from_jax(jax.jit(jpp_ref, static_argnames="q_start")(
        to_jax(q, dtype), *map(jnp.asarray, (kp, vp, ks, vs, table)),
        q_start=q_start))
    return [to_torch(x, dtype) for x in (q, kp, vp, ks, vs, table)], want


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_decode_model_matches_reference(case, dtype):
    t, want, plan = decode_case(case, dtype)
    got = model_decode(*t, plan=plan)
    assert got.dtype == dtype
    assert att_ok(got, want, dtype), (got.float() - want).abs().max()


@pytest.mark.parametrize("case,dtype", [
    pytest.param(c, d, id=f"{c[0]}-{'f32' if d == torch.float32 else 'bf16'}")
    for c in PREFILL for d in c[7]])
def test_prefill_model_matches_reference(case, dtype):
    t, want = prefill_case(case, dtype)
    got = model_prefill(*t, case[6])
    assert got.dtype == dtype
    assert att_ok(got, want, dtype), (got.float() - want).abs().max()


def test_one_part_for_p_times_vs_misses_the_bf16_bound():
    """Control: with w = p * vs in one bf16 part (q exact in one) the
    serving head's bf16 outputs leave one ULP + 1e-5 of the reference; the
    three parts the kernel uses hold it on the same inputs."""
    t, want, _ = decode_case(DECODE[0], torch.bfloat16)
    assert not att_ok(model_decode(*t, parts=(1, 1)), want, torch.bfloat16)
    assert att_ok(model_decode(*t), want, torch.bfloat16)


@pytest.mark.parametrize("units,max_tiles,want", [
    (16, 9, (9, 1)),      # K3 serving: B 8 x KV 2, 34 pages of 16
    (2, 65, (65, 1)),     # K3, B 1 x KV 2, 4,096 tokens
    (64, 17, (9, 2)),     # K3, B 32 x KV 2, up to 1,024 tokens
    (56, 12, (6, 2)),     # K2, C 256 x G 7 (28 row tiles) x KV 2, q_start 512
    (56, 4, (4, 1)),      # K2 at q_start 0
    (1000, 40, (1, 40)),  # enough blocks already: no split
])
def test_split_plan(units, max_tiles, want):
    """Splits are equal runs of at least one tile, and a grid of fewer
    blocks than the H100 has SMs is split until it has more, or until each
    split is one tile."""
    n_split, per = pa.split_plan(units, max_tiles, H100_SMS)
    assert (n_split, per) == want
    assert (n_split - 1) * per < max_tiles <= n_split * per
    if units < H100_SMS:
        assert units * n_split > H100_SMS or per == 1


def test_rows_per_block():
    assert [pa.rows_per_block(r) for r in (1, 7, 16, 17, 40, 64, 1792)] == \
        [16, 16, 16, 32, 48, 64, 64]


@pytest.mark.parametrize("hd,ok", [(160, True), (16, True), (256, True),
                                   (72, False), (272, False), (8, False)])
def test_check_pages_head_dims(hd, ok):
    """The kernels take any multiple of 16 from 16 to 256: stablelm-12b's
    page shapes (8 kv heads of hd 160) pass, hd 72 and 272 are refused."""
    kv, ps, g = 8, 16, 4
    q = torch.zeros(1, kv, g, hd, dtype=torch.bfloat16)
    kp = torch.zeros(4, kv, ps, hd, dtype=torch.int8)
    sc = torch.ones(4, kv, ps)
    if ok:
        assert pa.check_pages(q, kp, kp.clone(), sc, sc.clone(), kv, hd) == ps
    else:
        with pytest.raises(ValueError, match="multiple of 16"):
            pa.check_pages(q, kp, kp.clone(), sc, sc.clone(), kv, hd)

