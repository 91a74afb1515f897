"""A CPU model of the arithmetic of K8's bf16 kernel
(``src/repro_torch/csrc/flash_attention.cu``), held against the reference's
``flash_attention`` (the Pallas kernel in interpret mode, as
``tests/test_torch_flash_attention.py`` runs it) and against f64.

The kernel cannot run here, so this model does, in PyTorch, what it does on
the card, in its order of operations:

* blocks of 128 query rows, two warpgroups of 64 rows each; kv tiles of
  the build's width (128 columns at hd 128 and 160, else 64), walked up to
  the causal bound of the block's last row (a warpgroup may see a tile
  that is wholly masked for its rows);
* scores as the f32 product of bf16 q and k; the scale folded into the
  exponent: m is kept in units of log2 (max score times D^-0.5 log2(e)),
  p = exp2(s * D^-0.5 log2(e) - m) with the product and the subtraction
  rounded once (the kernel's FMA), corr = exp2(m_old - m_new);
* masked scores -inf in the exponent, applied only on tiles that cross
  the diagonal or the ragged end (``needs_mask``, the kernel's test; the
  model checks that no other tile has a masked score);
* p rounded to bf16 before the PV product, against the running max of the
  kernel's own tile order; l summed from the unrounded p; the output
  acc / max(l, 1e-30) rounded to bf16.

Limits: ``chip_smoke.py``'s for K8 in bf16, elementwise one bf16 ULP of
the larger magnitude + 2u·Σp|v|/l against the reference (u = 2^-8: each
side rounds every p to bf16 at its own running maximum; Σp|v|/l computed
here in f64 on |v|), and a root-mean-square distance to f64 no more than
twice the reference's; each head's RMS distance to the reference within
three times the reference's own RMS distance to f64; and the tighter one
ULP + 2e-3, an atol fitted to one seed on the card that the model meets
too. A control leaves one kv tile out for the later rows, as a kernel
that skipped a tile would, and must fail them; left out in one head only,
it must fail the per-head RMS check.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

BQ = 128                 # query rows a block
WG_ROWS = 64             # query rows a warpgroup
LOG2E = 1.4426950408889634
BF16_ULP_REL = 2.0 ** -7
K8_BF16_ATOL = 2e-3      # the fitted atol (see the module docstring)
K8_P_ROUND = 2.0 ** -8   # chip_smoke.py: bf16's unit roundoff
K8_ALL_RMS = 3.0         # chip_smoke.py: the per-head RMS check's factor
S_RAGGED = 208           # 3 tiles of 64 (1 of 128) and a ragged 16


def kv_tile(d: int) -> int:
    """kv columns a tile in the kernel build that takes head dim d."""
    return 128 if 64 < d <= 160 else 64


def needs_mask(k0: int, bk: int, row0: int, s: int, causal: bool) -> bool:
    """The kernel's test: tile k0 .. k0 + bk - 1 of the warpgroup whose
    first row is row0 crosses the diagonal or the ragged end."""
    return (causal and k0 + bk - 1 > row0) or k0 + bk > s


def model(q, k, v, causal, drop_tile=None):
    """K8's bf16 arithmetic on (BH, S, D) bf16 tensors; ``drop_tile``
    leaves that kv tile out for the rows from S / 2 on."""
    bh, s, d = q.shape
    bk = kv_tile(d)
    scale_log2 = np.float32(np.float32(d ** -0.5) * np.float32(LOG2E))
    pad = (-s) % BQ
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, pad))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    out = torch.empty(bh, s + pad, d)
    masked_tiles = 0
    for q0 in range(0, s, BQ):
        last_row = min(q0 + BQ, s) - 1
        n = last_row // bk + 1 if causal else math.ceil(s / bk)
        for row0 in (q0, q0 + WG_ROWS):
            rows = torch.arange(row0, row0 + WG_ROWS)
            qw = qf[:, row0:row0 + WG_ROWS]
            m = torch.full((bh, WG_ROWS, 1), -1e30)
            l = torch.zeros(bh, WG_ROWS, 1)
            acc = torch.zeros(bh, WG_ROWS, d)
            for j in range(n):
                k0 = j * bk
                cols = torch.arange(k0, k0 + bk)
                sc = qw @ kf[:, k0:k0 + bk].transpose(1, 2)
                hidden = cols[None, :] >= s
                if causal:
                    hidden = hidden | (cols[None, :] > rows[:, None])
                if needs_mask(k0, bk, row0, s, causal):
                    masked_tiles += 1
                    sc = sc.masked_fill(hidden, -math.inf)
                else:
                    assert not hidden.any(), (k0, row0)
                if drop_tile == j:
                    sc = sc.masked_fill((rows >= s // 2)[:, None], -math.inf)
                mx = sc.amax(dim=-1, keepdim=True)
                m_new = torch.maximum(m, mx * scale_log2)
                corr = torch.exp2(m - m_new)
                # the FMA: s * scale_log2 - m rounded once
                p = torch.exp2((sc.double() * float(scale_log2)
                                - m_new.double()).float())
                l = l * corr + p.sum(dim=-1, keepdim=True)
                pv = p.to(torch.bfloat16).float() @ vf[:, k0:k0 + bk]
                acc = acc * corr + pv
                m = m_new
            out[:, row0:row0 + WG_ROWS] = acc / torch.clamp(l, min=1e-30)
    return out[:, :s].to(torch.bfloat16), masked_tiles


def f64_attention(q, k, v, causal):
    s = q.shape[1]
    sc = (q.double() @ k.double().transpose(1, 2)) * q.shape[-1] ** -0.5
    if causal:
        cols = torch.arange(s)
        sc = sc.masked_fill(cols[None, :] > cols[:, None], -math.inf)
    return torch.softmax(sc, dim=-1) @ v.double()


def within_limits(got, want, exact):
    """chip_smoke.py's K8 bf16 checks: elementwise one ULP + 2e-3 against
    the reference, and RMS to f64 no more than twice the reference's."""
    a, b = got.float(), want.float()
    elem = bool(((a - b).abs() <= K8_BF16_ATOL + BF16_ULP_REL
                 * torch.maximum(a.abs(), b.abs())).all())

    def rms(x):
        return x.double().pow(2).mean().sqrt().item()
    return elem and rms(got.double() - exact) <= 2 * rms(want.double()
                                                         - exact)


def within_derived_bound(got, want, exact, p_bound):
    """chip_smoke.py's K8 bf16 checks: elementwise one ULP + ``p_bound``
    (2u·Σp|v|/l) against the reference, and RMS to f64 no more than twice
    the reference's."""
    a, b = got.float(), want.float()
    elem = bool(((a - b).abs() <= p_bound + BF16_ULP_REL
                 * torch.maximum(a.abs(), b.abs())).all())

    def rms(x):
        return x.double().pow(2).mean().sqrt().item()
    return elem and rms(got.double() - exact) <= 2 * rms(want.double()
                                                         - exact)


def within_every_element(got, want, exact):
    """chip_smoke.py's K8 bf16 check over every element: each head's RMS
    distance to the reference within ``K8_ALL_RMS`` times the reference's
    own RMS distance to f64."""
    per_head = (got.double() - want.double()).pow(2).mean(dim=(1, 2)).sqrt()
    own = (want.double() - exact).pow(2).mean().sqrt()
    return bool((per_head <= K8_ALL_RMS * own).all())


def p_bound(q, k, v, causal):
    return 2 * K8_P_ROUND * f64_attention(q, k, v.abs(), causal)


def inputs(d, bh=2, s=S_RAGGED, seed=0):
    rng = np.random.default_rng(seed + d)
    return [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]


def reference(q, k, v, causal):
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    return torch.from_numpy(to_numpy(jax_flash(jq, jk, jv, causal=causal,
                                               interpret=True))).bfloat16()


@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_model_within_chip_limits(d, causal):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got, _ = model(tq, tk, tv, causal)
    want = reference(q, k, v, causal)
    assert got.shape == want.shape == (2, S_RAGGED, d)
    assert within_limits(got, want, f64_attention(tq, tk, tv, causal))


@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_model_within_derived_bound(d, causal):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got, _ = model(tq, tk, tv, causal)
    want = reference(q, k, v, causal)
    assert within_derived_bound(got, want, f64_attention(tq, tk, tv, causal),
                                p_bound(tq, tk, tv, causal))


@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_dropped_tile_fails_the_derived_bound(d):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    exact = f64_attention(tq, tk, tv, True)
    bound = p_bound(tq, tk, tv, True)
    want = reference(q, k, v, True)
    good, _ = model(tq, tk, tv, True)
    bad, _ = model(tq, tk, tv, True, drop_tile=1)
    assert within_derived_bound(good, want, exact, bound)
    assert not within_derived_bound(bad, want, exact, bound)


@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_dropped_tile_fails_the_limits(d):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    exact = f64_attention(tq, tk, tv, True)
    want = reference(q, k, v, True)
    good, _ = model(tq, tk, tv, True)
    bad, _ = model(tq, tk, tv, True, drop_tile=1)
    assert within_limits(good, want, exact)
    assert not within_limits(bad, want, exact)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("s, causal, most", [
    (S_RAGGED, True, None), (S_RAGGED, False, None),
    (1024, True, 2 * 1024 // WG_ROWS), (1024, False, 0)])
def test_mask_only_on_crossing_tiles(d, s, causal, most):
    """The model asserts that a tile the kernel leaves unmasked has no
    masked score; on a long S only the diagonal's tiles (at most two a
    warpgroup) and the ragged end are masked, with 64- and 128-column
    tiles."""
    q = torch.zeros(1, s, d, dtype=torch.bfloat16)
    _, masked = model(q, q, q, causal)
    if most is not None:
        assert masked <= most


@pytest.mark.parametrize("d", [64, 128, 160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_model_within_every_element_check(d, causal):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got, _ = model(tq, tk, tv, causal)
    want = reference(q, k, v, causal)
    assert within_every_element(got, want, f64_attention(tq, tk, tv, causal))


@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_dropped_tile_in_one_head_fails_every_element_check(d):
    q, k, v = inputs(d)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    exact = f64_attention(tq, tk, tv, True)
    want = reference(q, k, v, True)
    good, _ = model(tq, tk, tv, True)
    bad = good.clone()
    bad[1] = model(tq, tk, tv, True, drop_tile=1)[0][1]
    assert within_every_element(good, want, exact)
    assert not within_every_element(bad, want, exact)
