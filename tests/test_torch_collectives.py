"""The port's collectives and row-parallel linear on four gloo ranks,
against the reference's arithmetic.

One spawned group of four CPU ranks (``tests/torch_tp_worker.py::
collectives``) runs every check and returns its outputs; the reference
runs here, in the parent, on the same numpy inputs:

* ``quantized_psum`` bit for bit against ``jax.vmap(quantized_psum,
  axis_name="model")`` over the same four partials, on every rank;
* the f32 ``psum`` of two ranks bit for bit (one addition commutes);
* ``ring_collective_matmul`` within 1e-5 of ``x @ w``;
  ``int8_allreduce_mean`` within one quantization step;
* ``row_parallel_linear`` in w8a8 and w4a8 (packed K shards), wire off and
  on: each rank's partial bit for bit against the jitted reference
  ``linear`` on its K-shard (the reference's ``shard_map`` body); the f32
  reduce within 1e-6 of the partials' sum (gloo's ring adds four partials
  in another order than XLA); the int8-wire reduce bit for bit against
  ``quantized_psum`` of the reference's partials; both within 5% of the
  single-device fused GEMM's span (the reference's QUANT bound).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_worker  # noqa: E402
from repro.core.camp import prepare_weight  # noqa: E402
from repro.core.quant import QuantizedTensor as JaxQT  # noqa: E402
from repro.models.modules import linear as jax_linear  # noqa: E402
from repro.parallel.collectives import \
    quantized_psum as jax_quantized_psum  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402

TP = 4
QMODES = ("w8a8", "w4a8")


def _vmap_qpsum(partials):
    return np.asarray(jax.vmap(lambda a: jax_quantized_psum(a, "model"),
                               axis_name="model")(jnp.asarray(partials)))


def _ref_k_shard(w, r):
    rows = w.q.shape[0] // TP
    return JaxQT(q=w.q[r * rows:(r + 1) * rows], scale=w.scale, bits=w.bits,
                 shape=(w.shape[0] // TP, w.shape[1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("collectives")
    partials = rng.standard_normal((TP, 16, 32)).astype(np.float32)
    partials[2, 3, 4] = 9.0              # one rank holds the global absmax
    xx = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jw = {q: prepare_weight(jnp.asarray(
        rng.standard_normal((64, 32)), jnp.float32), q) for q in QMODES}
    inp = {"partials": torch.from_numpy(partials),
           "ring_x": torch.from_numpy(
               rng.standard_normal((16, 32)).astype(np.float32)),
           "ring_w": torch.from_numpy(
               rng.standard_normal((32, 8)).astype(np.float32)),
           "grad": torch.from_numpy(
               rng.standard_normal((8, 16)).astype(np.float32)),
           "x": torch.from_numpy(xx),
           "weights": from_jax_params(jax_to_numpy(jw), device="cpu")}
    torch.save(inp, d / "inputs.pt")
    ranks = spawn_ranks(torch_tp_worker.collectives, TP, init_dir=str(d),
                        backend="gloo", device="cpu", args=(d / "inputs.pt",),
                        timeout=120)
    ref = {"qpsum": _vmap_qpsum(partials)}
    for qmode, w in jw.items():
        lin = jax.jit(lambda x, w, q=qmode: jax_linear(x, w, qmode=q))
        parts = np.stack([np.asarray(lin(
            jnp.asarray(xx[..., r * 16:(r + 1) * 16]), _ref_k_shard(w, r)),
            np.float32) for r in range(TP)])
        ref[f"partials/{qmode}"] = parts
        ref[f"wire/{qmode}"] = _vmap_qpsum(parts)
        ref[f"single/{qmode}"] = np.asarray(lin(jnp.asarray(xx), w),
                                            np.float32)
    return inp, ranks, ref


def test_quantized_psum_bit_for_bit_on_every_rank(runs):
    _, ranks, ref = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["qpsum"], ref["qpsum"][r])


def test_quantized_psum_within_one_step_a_rank_of_the_sum(runs):
    inp, ranks, _ = runs
    p = inp["partials"].numpy()
    step = np.abs(p).max() / 127.0
    assert np.abs(ranks[0]["qpsum"] - p.sum(0)).max() <= TP * step / 2 + 1e-6


def test_psum_of_two_ranks_is_exact(runs):
    inp, ranks, _ = runs
    p = inp["partials"].numpy()
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["psum2"], p[0] + p[1])
    assert "psum2" not in ranks[2] and "psum2" not in ranks[3]


def test_ring_collective_matmul(runs):
    inp, ranks, _ = runs
    got = np.concatenate([out["ring"] for out in ranks], axis=1)
    want = inp["ring_x"].numpy() @ inp["ring_w"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_allreduce_mean_within_one_step(runs):
    inp, ranks, _ = runs
    g = inp["grad"].numpy()
    step = np.abs(g).max() / 127.0
    for out in ranks:          # every rank holds the same g: mean == g
        assert np.abs(out["mean"] - g).max() <= step


def test_gather_and_broadcast_in_rank_order(runs):
    inp, ranks, _ = runs
    want = np.concatenate(list(inp["partials"].numpy()), axis=-1)
    for out in ranks:
        np.testing.assert_array_equal(out["gather"], want)
        assert out["bcast"] == [0, 1]


@pytest.mark.parametrize("qmode", QMODES)
def test_row_parallel_partials_match_reference_shard_body(runs, qmode):
    _, ranks, ref = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"partial/{qmode}"],
                                      ref[f"partials/{qmode}"][r])


@pytest.mark.parametrize("qmode", QMODES)
def test_row_parallel_f32_reduce(runs, qmode):
    _, ranks, ref = runs
    want = ref[f"partials/{qmode}"].sum(0)
    tol = 1e-6 * np.abs(want).max()
    for out in ranks:
        got = out[f"reduced/{qmode}/False"]
        assert np.abs(got - want).max() <= tol
        np.testing.assert_array_equal(got, ranks[0][f"reduced/{qmode}/False"])


@pytest.mark.parametrize("qmode", QMODES)
def test_row_parallel_int8_wire_bit_for_bit(runs, qmode):
    _, ranks, ref = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"reduced/{qmode}/True"],
                                      ref[f"wire/{qmode}"][r])


@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("wire", [False, True], ids=["f32", "int8wire"])
def test_row_parallel_tracks_single_device_gemm(runs, qmode, wire):
    _, ranks, ref = runs
    single = ref[f"single/{qmode}"]
    span = np.abs(single).max()
    got = ranks[0][f"reduced/{qmode}/{wire}"]
    assert np.abs(got - single).max() <= 0.05 * span
