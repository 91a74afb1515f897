"""The port's optimizer, schedule, QAT pieces and losses against the JAX
reference, on the same numpy inputs:

* ``cosine_schedule`` equal to the jitted reference's within one f32 ULP
  at the peak's magnitude (the two cosines are different libms, and near
  the end of the decay ``1 + cos`` cancels, so a last-bit difference of
  the cosine is a few ULPs of the result there);
* ``int8_moment_quant`` / ``_int8_compress`` / ``fake_quant`` bit for bit
  against ``jax.jit`` of the reference's (its chain: ``absmax ·
  f32(1/qmax)``, then a true division), with a zero row and a 0-d leaf;
  ``fake_quant``'s gradient is the identity;
* ``adamw``'s update on the same gradients, f32, within 1e-6 of each
  leaf's largest update, with and without int8 moments;
* ``qat_matmul``, ``softmax_xent`` and ``chunked_xent`` (and its gradient)
  in f32 within 1e-6.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_parity import (assert_ulps, jax_to_numpy, one_thread,  # noqa: E402,F401
                          to_numpy)

from repro.core.camp import qat_matmul as jax_qat_matmul  # noqa: E402
from repro.core.quant import fake_quant as jax_fake_quant  # noqa: E402
from repro.models.modules import chunked_xent as jax_chunked_xent  # noqa: E402
from repro.models.modules import softmax_xent as jax_softmax_xent  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.optim.adamw import int8_moment_quant as jax_moment_quant  # noqa: E402
from repro.train.train_step import _int8_compress as jax_compress  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.camp import qat_matmul  # noqa: E402
from repro_torch.core.quant import dequantize_rowwise, fake_quant  # noqa: E402
from repro_torch.models.modules import chunked_xent, softmax_xent  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.optim.adamw import (int8_moment_dequant,  # noqa: E402
                                     int8_moment_quant)
from repro_torch.train.train_step import _int8_compress  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402

UPDATE_TOL = 1e-6     # f32 updates, as a share of each leaf's largest
XENT_TOL = 1e-6       # f32 losses and gradients, relative


def rows(seed=0, shape=(33, 257), scale=1e-3):
    """f32 values (rows of the last axis, row 3 zero where there is one)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    if x.ndim > 1:
        x.reshape(-1, x.shape[-1])[3] = 0.0
    return x


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (10, 10),
                                          (3, 37)])
def test_cosine_schedule_matches_reference(warmup, total):
    s = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.jit(jax_cosine(3e-3, warmup, total))(s))
    got = cosine_schedule(3e-3, warmup, total)(torch.from_numpy(s)).numpy()
    assert got.dtype == np.float32
    assert_ulps(got, want, 1, "float32", scale=3e-3)


@pytest.mark.parametrize("sqrt_transform", [False, True])
@pytest.mark.parametrize("shape", [(33, 257), (4, 5, 16), (64,), ()])
def test_int8_moment_quant_bit_for_bit(shape, sqrt_transform):
    x = rows(1, shape)
    x = np.array(np.abs(x) if sqrt_transform else x)
    want = jax.jit(lambda t: jax_moment_quant(
        t, sqrt_transform=sqrt_transform))(x)
    got = int8_moment_quant(torch.from_numpy(x), sqrt_transform=sqrt_transform)
    for k in ("q", "scale"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = int8_moment_dequant(got, sqrt_transform=sqrt_transform,
                               scalar=shape == ())
    assert tuple(back.shape) == shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_compress_bit_for_bit(dtype):
    x = rows(2)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax.jit(jax_compress)(jx).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = _int8_compress(tx)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(to_numpy(got), want)
    scalar = torch.tensor(0.25)
    assert _int8_compress(scalar) is scalar        # 0-d leaves pass through


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_bit_for_bit_and_straight_through(bits):
    x = rows(3, (16, 96), 1.0)
    want = np.asarray(jax.jit(lambda t: jax_fake_quant(t, bits))(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = fake_quant(tx, bits)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = torch.randn(16, 96, generator=torch.Generator().manual_seed(0))
    (got * g).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), g.numpy())
    jg = jax.grad(lambda t: jnp.sum(jax_fake_quant(t, bits) * g.numpy()))(x)
    np.testing.assert_array_equal(np.asarray(jg), g.numpy())


def test_qat_matmul_matches_reference():
    x, w = rows(4, (8, 64), 1.0), rows(5, (64, 48), 0.1)
    want = np.asarray(jax.jit(jax_qat_matmul)(x, w))
    got = qat_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=XENT_TOL,
                               atol=XENT_TOL * np.abs(want).max())


def test_dequantize_rowwise():
    q = torch.tensor([[-127, 0, 5]], dtype=torch.int8)
    s = torch.tensor([[0.5]])
    assert dequantize_rowwise(q, s).tolist() == [[-63.5, 0.0, 2.5]]
    assert dequantize_rowwise(q, s, torch.float64).dtype == torch.float64


def _tree(rng, scales):
    """A params-like tree: a matrix, two 1-D leaves in a list, a 0-d leaf."""
    w, n0, n1, gain = scales
    return {"w": (rng.standard_normal((32, 48)) * w).astype(np.float32),
            "layers": [{"norm": (rng.standard_normal(48) * n0
                                 ).astype(np.float32)},
                       {"norm": (rng.standard_normal(48) * n1
                                 ).astype(np.float32)}],
            "gain": np.asarray(rng.standard_normal() * gain, np.float32)}


def _grad_tree(seed):
    """Params and three gradient trees for them, each with a zero row."""
    rng = np.random.default_rng(seed)
    params = _tree(rng, (0.1, 0.1, 0.1, 1.0))
    grads = [_tree(rng, (1e-2, 1e-3, 1.0, 1.0)) for _ in range(3)]
    for g in grads:
        g["w"][5] = 0.0
    return params, grads


@pytest.mark.parametrize("quantize_moments", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_update_on_reference_gradients(quantize_moments, weight_decay):
    """Three updates of both optimizers on the same gradients (the third
    clipped by the global norm); each update within UPDATE_TOL of the
    leaf's largest, the moments' int8 payloads equal but for rare
    last-bit roundings of m (at most 1 step apart)."""
    p_np, g_np = _grad_tree(7)
    lr = jax_cosine(1e-3, 1, 3)
    jopt = jax_adamw(lr=lr, weight_decay=weight_decay,
                     quantize_moments=quantize_moments)
    opt = adamw(lr=cosine_schedule(1e-3, 1, 3), weight_decay=weight_decay,
                quantize_moments=quantize_moments)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = from_jax_params(p_np, device="cpu")
    js, ts = jopt.init(jp), opt.init(tp)
    jup = jax.jit(jopt.update)
    for g in g_np:
        ju, js = jup(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = opt.update(from_jax_params(g, device="cpu"), ts, tp)
        for (path, a), b in zip(leaves_with_path(jax_to_numpy(ju)),
                                leaves(tu)):
            a = np.asarray(a)
            assert b.shape == a.shape and b.dtype == torch.float32, path
            tol = UPDATE_TOL * np.abs(a).max()
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol,
                                       err_msg=str(path))
        assert int(ts["count"]) == int(js["count"])
        for key in ("m", "v"):
            for (path, a), b in zip(leaves_with_path(jax_to_numpy(js[key])),
                                    leaves(ts[key])):
                a = np.asarray(a)
                if a.dtype == np.int8:
                    diff = np.abs(b.numpy().astype(int) - a.astype(int))
                    assert diff.max(initial=0) <= 1, (key, path)
                    assert (diff > 0).mean() < 0.01, (key, path)
                else:
                    np.testing.assert_allclose(
                        b.numpy(), a, rtol=UPDATE_TOL,
                        atol=UPDATE_TOL * np.abs(a).max(initial=0),
                        err_msg=f"{key} {path}")
        jp = jax.tree.map(lambda x, u: x + u, jp, ju)
        tp = tree_map(torch.add, tp, tu)


@pytest.mark.parametrize("v,n_chunks", [(512, 8), (520, 8), (96, 5)])
def test_chunked_xent_matches_softmax_xent_and_reference(v, n_chunks):
    rng = np.random.default_rng(v)
    h = rng.standard_normal((2, 12, 32)).astype(np.float32)
    head = rng.standard_normal((32, v)).astype(np.float32) * 0.2
    labels = rng.integers(0, v, (2, 12)).astype(np.int32)
    th = torch.from_numpy(h).requires_grad_(True)
    thead = torch.from_numpy(head).requires_grad_(True)
    got = chunked_xent(th, thead, torch.from_numpy(labels), n_chunks=n_chunks)
    full = softmax_xent(th @ thead, torch.from_numpy(labels))
    want, (jgh, jghead) = jax.jit(jax.value_and_grad(
        lambda a, b: jax_chunked_xent(a, b, labels, n_chunks=n_chunks),
        argnums=(0, 1)))(h, head)
    jfull = jax.jit(jax_softmax_xent)(h @ head, labels)
    for a in (full.detach().item(), float(want), float(jfull)):
        np.testing.assert_allclose(got.detach().item(), a, rtol=XENT_TOL)
    gh, ghead = torch.autograd.grad(got, (th, thead))
    for a, b in ((gh, jgh), (ghead, jghead)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=XENT_TOL * np.abs(b).max())
