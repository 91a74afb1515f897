"""The port's examples (``examples/torch/``) on the CPU, and the pieces they
needed: ``QuantizedTensor.memory_bytes``, ``PagePool.page_bytes`` and
``QuantizedTensor`` checkpoint leaves, each against the reference.

Each example runs in this process through its ``main(argv)`` with
``--device cpu`` (``train_100m`` with 2 steps of 2 × 16 tokens, the
checkpoints in ``tmp_path``), and the test checks the equalities it
prints: the quickstart's weight bytes equal the reference's and its hybrid
identity holds, the speculative greedy stream equals the plain one, and
the resumed training equals the uninterrupted run.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import camp as jax_camp  # noqa: E402
from repro.core.quant import QuantizedTensor as JaxQT  # noqa: E402
from repro.core.quant import \
    quantize_weight as jax_quantize_weight  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.kv_cache import PagePool as JaxPagePool  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.core import camp  # noqa: E402
from repro_torch.core.quant import (QuantizedTensor,  # noqa: E402
                                    quantize_weight)
from repro_torch.serving.kv_cache import PagePool  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"
QT_QMODES = ("w8a8", "w4a8", "w4a4", "w8a16", "w4a16")


def example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv, capsys):
    assert example(name).main(["--device", "cpu", *argv]) == 0
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qmode", QT_QMODES)
@pytest.mark.parametrize("shape", [(64, 48), (1024, 512)])
def test_memory_bytes_matches_reference(qmode, shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = camp.prepare_weight(torch.from_numpy(w), qmode)
    want = jax_camp.prepare_weight(jnp.asarray(w), qmode)
    assert isinstance(got, QuantizedTensor) and isinstance(want, JaxQT)
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("ps", [8, 16])
def test_page_bytes_matches_reference(kind, ps):
    kw = dict(n_layers=3, n_kv_heads=2, head_dim=16, num_pages=5,
              page_size=ps, quantized=kind == "int8")
    got = PagePool(**kw, dtype=getattr(torch, kind if kind != "int8"
                                       else "bfloat16"))
    want = JaxPagePool(**kw, dtype=getattr(jnp, kind if kind != "int8"
                                           else "bfloat16"))
    assert got.page_bytes() == want.page_bytes()


def test_page_bytes_of_a_sharded_pool_counts_every_head():
    """A rank of a head-sharded pool reports the model's page bytes, as
    the reference (whose pool is the global array) does."""
    class Mesh:
        shape = {"data": 1, "model": 2}
    kw = dict(n_layers=2, n_kv_heads=4, head_dim=16, num_pages=3)
    pool = PagePool(**kw, mesh=Mesh())
    assert pool.sharded and pool.local_kv_heads == 2
    assert pool.page_bytes() == JaxPagePool(**kw).page_bytes()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tensor_leaves_roundtrip(tmp_path, bits):
    """Mirrors the reference's test of the same name; the keys are the
    reference's, so each package restores the other's file."""
    w = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    state = {"qw": quantize_weight(torch.from_numpy(w), bits),
             "x": torch.ones(3)}
    ckpt.save(tmp_path / "port", state, 1)
    back = ckpt.restore(tmp_path / "port", state)
    assert isinstance(back["qw"], QuantizedTensor)
    assert torch.equal(back["qw"].q, state["qw"].q)
    assert torch.equal(back["qw"].scale, state["qw"].scale)
    assert back["qw"].bits == bits and back["qw"].shape == (16, 8)
    jstate = {"qw": jax_quantize_weight(jnp.asarray(w), bits),
              "x": jnp.ones((3,))}
    jback = jax_ckpt.restore(tmp_path / "port", jstate)
    np.testing.assert_array_equal(np.asarray(jback["qw"].q),
                                  state["qw"].q.numpy())
    jax_ckpt.save(tmp_path / "ref", jstate, 1)
    back = ckpt.restore(tmp_path / "ref", state)
    np.testing.assert_array_equal(back["qw"].q.numpy(),
                                  np.asarray(jstate["qw"].q))
    np.testing.assert_array_equal(back["qw"].scale.numpy(),
                                  np.asarray(jstate["qw"].scale))


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------
def test_quickstart(capsys):
    out = run_example("quickstart", [], capsys)
    w = np.random.default_rng(0)
    w.standard_normal((256, 1024))
    w = jnp.asarray(w.standard_normal((1024, 512)).astype(np.float32))
    for qmode in ("w8a8", "w4a8", "w4a4"):
        want = jax_camp.prepare_weight(w, qmode).memory_bytes()
        assert f"{qmode}: weight bytes {want:>8} (fp32 2097152)" in out
    assert "CUDA kernel == plain version: not run on the CPU" in out
    assert "hybrid(4-bit blocks) == int8 dot: True" in out


def test_serve_quantized(capsys):
    out = run_example("serve_quantized", [], capsys)
    for qmode in ("none", "w8a8", "w4a8"):
        assert f"{qmode:>5}: weights" in out
    assert out.count("24 free at end") == 3
    assert "greedy streams bit-identical: True" in out


def test_train_100m(capsys, tmp_path):
    out = run_example("train_100m", ["--steps", "2", "--batch", "2",
                                     "--seq", "16", "--ckpt-dir",
                                     str(tmp_path)], capsys)
    cfg = jax_get_config("qwen3-0.6b", n_layers=6, d_model=512, n_heads=8,
                         n_kv_heads=4, head_dim=64, d_ff=2048,
                         vocab_size=32768, max_seq_len=256)
    shapes = jax.eval_shape(lambda k: jax_init_params(k, cfg),
                            jax.random.PRNGKey(0))
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert f"params: {n / 1e6:.1f}M" in out
    first, last = out.split("loss: ")[-1].split(" → ")
    assert np.isfinite(float(first)) and np.isfinite(float(last))


def test_fault_tolerance_demo(capsys, tmp_path):
    out = run_example("fault_tolerance_demo", ["--ckpt-dir", str(tmp_path)],
                      capsys)
    assert "resumed == uninterrupted: True" in out
    full, resumed = (line.split("=")[1] for line in
                     out.split("final losses: ")[-1].split())
    assert full == resumed
