"""The port's sharded (flat FSDP) training on a (2, 2) mesh of four gloo
CPU ranks, against the reference's sharded run and the port's one process.

One spawned group (``tests/torch_fsdp_worker.py::run_all``) runs every
sharded case once and returns its outputs; here, in the parent:

* the reference's initial states (``init_train_state(PRNGKey(0))`` of the
  reduced qwen3-0.6b in f32, f32 moments and int8 moments) are built live,
  held to the digests of ``tests/fsdp_reference.json`` and converted; the
  recording holds the reference's sharded and single-device runs (3 steps,
  ``tests/fsdp_reference.py``; its multi-device JAX runs in a subprocess
  of the recorder, not here);
* the port's one-process run from the same states and batches.

Tolerances (f32): loss and grad_norm within ``METRIC_RTOL`` relative of
both the recording's sharded run and the port's one process; the sampled
parameter values within ``PARAM_TOL`` · max(1, |value|). The sharded step
reduces each gradient in another order than one process (four row blocks
summed by gloo), so f32 rounding differs: measured, loss 2.4e-7, grad_norm
8.1e-6 (the port's one-process gradients already differ from the
reference's by ~5e-6, tests/test_torch_train.py) and the sampled params
5.6e-6. With int8 moments and gradients such a difference could move an
int8 value by one step; at these samples none does.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import fsdp_reference as fr  # noqa: E402
import torch_fsdp_worker  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.data import (SyntheticLMData, batch_specs,  # noqa: E402
                              shard_batch)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.parallel.sharding import make_rules, spec_for  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from spec_reference import weight_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402

METRIC_RTOL = 1e-5
PARAM_TOL = 1e-5
CASES = {name: (qm, cg) for name, qm, cg in fr.CASES}
INDIVISIBLE = (6, 3)     # rows: 6 bind data only on (2, 2), 3 bind nothing


class _Mesh:
    def __init__(self, d, m, rank):
        self.shape = {"data": d, "model": m}
        self.coords = {"data": rank // m, "model": rank % m}
        self.device = torch.device("cpu")


def _jax_state(name):
    cfg = fr.config(jax_get_config)
    qm, _ = CASES[name]
    return jax_init_train_state(jax.random.PRNGKey(0), cfg,
                                jax_adamw(lr=fr.LR, quantize_moments=qm))


def _samples(params) -> dict:
    flat = [("/".join(map(str, p)), np.asarray(x, np.float32))
            for p, x in leaves_with_path(params)]
    return fr.samples(flat)


def _one_process(name, state, batches):
    qm, cg = CASES[name]
    from repro_torch.optim import adamw
    from repro_torch.train import build_train_step
    cfg = fr.config(get_config)
    step = build_train_step(cfg, adamw(lr=fr.LR, quantize_moments=qm),
                            compress_grads=cg)
    out = dict(loss=[], grad_norm=[], params=[])
    for b in batches:
        state, m = step(state, shard_batch(b, device="cpu"))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(_samples(state["params"]))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    rec = json.loads(fr.JSON_PATH.read_text())
    d = tmp_path_factory.mktemp("fsdp")
    cfg = fr.config(get_config)
    batches = fr.batches(SyntheticLMData, cfg.vocab_size)
    indiv = [SyntheticLMData(cfg.vocab_size, n, 32, seed=1).batch_at(0)
             for n in INDIVISIBLE]
    states, jstates, digests = {}, {}, {}
    for name in CASES:
        jstates[name] = _jax_state(name)
        digests[name] = weight_digest(jax_to_numpy(jstates[name]))
        states[name] = from_jax_train_state(jax_to_numpy(jstates[name]),
                                            device="cpu")
    jax_ckpt.save(d / "ref", jstates["f32"], 0)
    one = {name: _one_process(name, states[name], batches)
           for name in CASES}
    one_indiv = {name: [_one_process(name, states[name], [b])
                        for b in indiv] for name in CASES}
    torch.save(dict(states=states, batches=batches, indivisible=indiv,
                    tmp=str(d), ref_ckpt=str(d / "ref")), d / "inputs.pt")
    ranks = spawn_ranks(torch_fsdp_worker.run_all, 4, init_dir=str(d),
                        backend="gloo", device="cpu",
                        args=(d / "inputs.pt",), timeout=240,
                        shape=(2, 2))
    return dict(rec=rec, digests=digests, one=one, one_indiv=one_indiv,
                ranks=ranks, jstates=jstates, states=states, dir=d)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_recording_digests_match_the_reference(run):
    for name in CASES:
        assert run["rec"]["cases"][name]["state_sha256"] == run["digests"][
            name]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["recorded_sharded", "recorded_single",
                                     "port_one_process"])
def test_sharded_metrics_match(run, name, against):
    want = (run["one"][name] if against == "port_one_process"
            else run["rec"]["cases"][name][against.split("_")[1]])
    for r in run["ranks"]:
        got = r[name]
        for key in ("loss", "grad_norm"):
            for g, w in zip(got[key], want[key]):
                assert _rel(g, w) <= METRIC_RTOL, (r["rank"], key, g, w)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["recorded_sharded", "port_one_process"])
def test_sharded_params_match(run, name, against):
    want = (run["one"][name]["params"] if against == "port_one_process"
            else run["rec"]["cases"][name]["sharded"]["params"])
    got = [_samples(p) for p in run["ranks"][0][name]["params"]]
    for s, (g_step, w_step) in enumerate(zip(got, want)):
        for key, w in w_step.items():
            g, w = np.asarray(g_step[key]), np.asarray(w)
            lim = PARAM_TOL * np.maximum(1, np.abs(w))
            assert np.all(np.abs(g - w) <= lim), (s, key)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("i", range(len(INDIVISIBLE)))
def test_indivisible_batch_counts_rows_once(run, name, i):
    want = run["one_indiv"][name][i]
    for r in run["ranks"]:
        got = r[name + " indivisible"][i]
        for key in ("loss", "grad_norm"):
            assert _rel(got[key][0], want[key][0]) <= METRIC_RTOL, (
                r["rank"], key)


@pytest.mark.parametrize("n", [8, 6, 3])
def test_shard_batch_is_numpy_slices(n):
    rules = make_rules("train", family="dense")
    batch = SyntheticLMData(512, n, 16, seed=2).batch_at(0)
    want_rows = {8: lambda c: slice(2 * (2 * c["data"] + c["model"]),
                                    2 * (2 * c["data"] + c["model"]) + 2),
                 6: lambda c: slice(3 * c["data"], 3 * c["data"] + 3),
                 3: lambda c: slice(0, 3)}[n]
    for rank in range(4):
        mesh = _Mesh(2, 2, rank)
        specs = batch_specs(batch, rules, mesh)
        assert specs["inputs"] == spec_for((n, 16), ("batch", "seq"), rules,
                                           mesh)
        got = shard_batch(batch, mesh=mesh, specs=specs)
        rows = want_rows(mesh.coords)
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k].numpy(), v[rows])
        assert got.shards == {8: 4, 6: 2, 3: 1}[n]


def test_shard_batch_recurrent_families_bind_data_only():
    rules = make_rules("train", family="ssm")
    batch = SyntheticLMData(512, 8, 16, seed=2).batch_at(0)
    got = shard_batch(batch, mesh=_Mesh(2, 2, 3),
                      specs=batch_specs(batch, rules, _Mesh(2, 2, 3)))
    assert got.axes == ("data",) and got.shards == 2
    np.testing.assert_array_equal(got["labels"].numpy(), batch["labels"][4:])


def test_sharded_global_norm_equals_the_whole(run):
    for r in run["ranks"]:
        sharded, whole = r["norm"]
        assert _rel(sharded, whole) <= 1e-6


def test_int8_scales_on_shards_are_slices_of_the_whole(run):
    split = 0
    for r in run["ranks"]:
        for row in r["quant"]:
            assert row["moment_exact"] and row["grad_exact"], (r["rank"], row)
            split += row["split"]
    assert split


def test_local_absmax_control_differs(run):
    """The block-local absmax gives other scales wherever the last dim is
    split (on some rank: the block holding a row's maximum agrees)."""
    for path in {row["path"] for row in run["ranks"][0]["quant"]
                 if row["split"]}:
        assert not all(row["control_exact"] for r in run["ranks"]
                       for row in r["quant"] if row["path"] == path), path


def test_checkpoint_restores_on_one_process_and_other_meshes(run, tmp_path):
    saved = run["ranks"][0]["saved_state"]
    like = run["states"]["int8"]
    back = ckpt.restore(run["dir"] / "port", like)
    flat_saved = leaves_with_path(saved)
    for (path, b), (_, s) in zip(leaves_with_path(back), flat_saved):
        np.testing.assert_array_equal(np.asarray(b), s, err_msg=str(path))
    for (path, b), (_, s) in zip(
            leaves_with_path(run["ranks"][0]["restored_1x2"]), flat_saved):
        np.testing.assert_array_equal(b, s, err_msg=str(path))
    assert all(r["restored_same_mesh"] for r in run["ranks"])


def test_checkpoints_cross_packages(run):
    """The reference's restore reads the port's sharded checkpoint, and
    the port's sharded restore reads the reference's."""
    back = jax_ckpt.restore(run["dir"] / "port", run["jstates"]["int8"])
    saved = run["ranks"][0]["saved_state"]
    for (path, s), b in zip(leaves_with_path(saved), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b, s.dtype), s,
                                      err_msg=str(path))
    assert all(r["ref_ckpt_exact"] for r in run["ranks"])


def test_restart_on_the_same_mesh_is_bit_for_bit(run):
    for r in run["ranks"]:
        assert r["restart"] == dict(steps=1, exact=True)


def test_loop_stops_where_rank_0_stops(run):
    for r in run["ranks"]:
        assert r["signal_rank1"] == dict(steps=3, saved=[])
        assert r["signal_rank0"] == dict(steps=2, saved=[2])


def test_moe_and_recurrent_models_take_a_sharded_step(run):
    """Reduced moonshot, jamba and rwkv6 take a sharded step on (2, 2)
    under their own train rules: loss and grad_norm within METRIC_RTOL of
    one process's from the same state and batch
    (``tests/test_torch_fsdp_families.py`` holds them to the
    reference)."""
    for r in run["ranks"]:
        assert set(r["families"]) == {"moonshot-v1-16b-a3b",
                                      "jamba-v0.1-52b", "rwkv6-7b"}
        for arch, got in r["families"].items():
            for key, (sharded, one) in got.items():
                assert np.isfinite(sharded), (arch, key)
                assert _rel(sharded, one) <= METRIC_RTOL, (arch, key)
