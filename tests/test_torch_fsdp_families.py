"""The port's sharded training of every model family, and its gathering
of one layer at a time, on a (2, 2) mesh of four gloo CPU ranks, against
the reference's sharded runs and the port's one process.

One spawned group (``tests/torch_fsdp_families_worker.py::run_all``)
runs every case of ``fsdp_families_reference.CASES`` (reduced
moonshot-v1-16b-a3b in f32, with int8 moments and gradients, and with
``grad_accum=2`` at AdamW's default eps and at eps 1e-5; reduced
jamba-v0.1-52b and rwkv6-7b) for 3 steps; here,
in the parent, the reference's initial states are built live, held to
the recording's digests (``tests/fsdp_families_reference.json``) and
converted, and the port's one process runs the same steps.

Tolerances (f32): loss and grad_norm within ``METRIC_RTOL`` relative,
the sampled parameters within ``PARAM_TOL`` · max(1, |value|), as
``tests/test_torch_fsdp.py`` holds the dense model, with at most
``OUTLIERS`` sampled value a step beyond it, and that one within one
AdamW step (``LR``): a gradient element at AdamW's eps (1e-8), where the
update g / (|g| + eps) follows the last bits of g, or an int8 moment
rounding that a last-bit difference flips, moves one value by up to a
step (measured: 2.6e-5, 6.8e-5 against the port's one process).

The ranks sum each gradient in another order than one process, so f32
rounding differs. Against the port's one process every case holds at
every step. Against the recording, moonshot in f32 and int8, and with
``grad_accum=2`` at eps 1e-5, holds at every step; ``PARTED``'s cases at
the first step (from the same state): after it their runs part through
such eps elements, the reference's own (jamba: its sharded run's
grad_norm 2.4e-3 from its single one at step 3) or between the two
packages' one-process runs (moonshot accum 2: 1.1e-2 in grad_norm at
step 3, rwkv6: 1.1e-3), so their later steps are held against the port's
one process alone. For moonshot accum 2 the cause is held here: one step
of both packages' one-process steps from one state gives gradients equal
within ``GRAD_RTOL`` of each leaf's largest everywhere, and the updates
that differ are all at gradient elements below ``EPS_BAND``; at eps 1e-5
the same runs hold the recording at every step. rwkv6's first grad_norm
against the recording:
``RWKV_NORM_RTOL``, its gradients' known gap to the reference's
(``tests/test_torch_train.py``'s GRAD_TOL; measured 2.7e-5).

Beside the runs: MoE routing over a group split between ranks at uneven
boundaries equals the reference's ``_route`` bit for bit (a control that
counts only the rank's own picks differs); the aux loss's gradient over
split rows within ``AUX_TOL`` of one process's (a control whose
all-reduce does not sum in the backward lies outside); the largest whole
bytes a rank holds at once is at most two layers' and the largest
top-level leaf's (a control that gathers the whole tree first exceeds
it); and a MoE checkpoint restores byte for byte on one process and on
(1, 2).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import fsdp_families_reference as ff  # noqa: E402
import fsdp_reference as fr  # noqa: E402
import torch_fsdp_families_worker  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_train_state  # noqa: E402
from repro_torch.data import (SyntheticLMData, batch_specs,  # noqa: E402
                              shard_batch)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import make_rules  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402
from spec_reference import weight_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402

METRIC_RTOL = 1e-5
PARAM_TOL = 1e-5
OUTLIERS = 1
LR = fr.LR
RWKV_NORM_RTOL = 1e-4
PARTED = ("moonshot accum 2", "jamba f32", "rwkv6 f32")
AUX_TOL = 1e-6
GRAD_RTOL = 1e-5
EPS_BAND = 10 * ff.EPS    # a gradient element this small is at AdamW's eps
CASES = ff.CASES


def _samples(params) -> dict:
    flat = [("/".join(map(str, p)), np.asarray(x, np.float32))
            for p, x in leaves_with_path(params)]
    return fr.samples(flat)


def _one_process(case, state, batches):
    arch, qm, cg, accum, eps = case
    cfg = ff.config(get_config, arch)
    step = build_train_step(cfg, adamw(lr=fr.LR, quantize_moments=qm,
                                       eps=eps),
                            grad_accum=accum, compress_grads=cg)
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
    rec = json.loads(ff.JSON_PATH.read_text())
    d = tmp_path_factory.mktemp("fsdp_families")
    states, digests, batches = {}, {}, {}
    for name, (arch, qm, _, _, _) in CASES.items():
        jcfg = ff.config(jax_get_config, arch)
        jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg,
                                      jax_adamw(lr=fr.LR,
                                                quantize_moments=qm))
        digests[name] = weight_digest(jax_to_numpy(jstate))
        states[name] = from_jax_train_state(jax_to_numpy(jstate),
                                            device="cpu")
        batches[name] = fr.batches(SyntheticLMData, jcfg.vocab_size)
    aux_x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 32, 64)).astype(np.float32))
    torch.save(dict(cases=CASES, states=states, batches=batches,
                    aux_x=aux_x, tmp=str(d)), d / "inputs.pt")
    one = {name: _one_process(case, states[name], batches[name])
           for name, case in CASES.items()}
    ranks = spawn_ranks(torch_fsdp_families_worker.run_all, 4,
                        init_dir=str(d), backend="gloo", device="cpu",
                        args=(d / "inputs.pt",), timeout=300, shape=(2, 2))
    return dict(rec=rec, digests=digests, one=one, ranks=ranks,
                states=states, dir=d)


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("name", list(CASES))
def test_recording_digests_match_the_reference(run, name):
    assert run["rec"]["cases"][name]["state_sha256"] == run["digests"][name]


def _compared(run, name, against):
    """(the port's sharded run, what it is held to), over the steps held."""
    got = run["ranks"][0][name]
    if against == "port_one_process":
        return got, run["one"][name], 3
    return got, run["rec"]["cases"][name]["sharded"], (
        1 if name in PARTED else 3)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["recorded_sharded", "port_one_process"])
def test_sharded_metrics_match(run, name, against):
    _, want, steps = _compared(run, name, against)
    for r in run["ranks"]:
        for key in ("loss", "grad_norm"):
            tol = (RWKV_NORM_RTOL if name.startswith("rwkv6")
                   and key == "grad_norm" and against != "port_one_process"
                   else METRIC_RTOL)
            for s in range(steps):
                g, w = r[name][key][s], want[key][s]
                assert _rel(g, w) <= tol, (r["rank"], key, s, g, w)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("against", ["recorded_sharded", "port_one_process"])
def test_sharded_params_match(run, name, against):
    got, want, steps = _compared(run, name, against)
    for s in range(steps):
        g_step = _samples(got["params"][s])
        far = []
        for key, w in want["params"][s].items():
            g, w = np.asarray(g_step[key]), np.asarray(w)
            gap = np.abs(g - w) / np.maximum(1, np.abs(w))
            far += [(key, float(x)) for x in gap[gap > PARAM_TOL]]
        assert len(far) <= OUTLIERS and all(x <= LR for _, x in far), (
            s, far)


def test_accumulated_gradient_matches_the_reference_but_at_eps(run):
    """Why "moonshot accum 2" parts from the recording after its first
    step: one step of each package's one-process step from the same state
    (``grad_accum=2``, AdamW's default eps) gives first moments (1 - b1 =
    0.1 times the clipped gradient) within ``GRAD_RTOL`` of each leaf's
    largest everywhere, and every parameter whose update differs by more
    than ``PARAM_TOL`` has a gradient element below ``EPS_BAND``, where
    the update g / (|g| + eps) follows the last bits of g. There are such
    parameters (measured 12, at |g| <= 6.4e-8)."""
    name = "moonshot accum 2"
    arch, _, _, accum, eps = CASES[name]
    jcfg = ff.config(jax_get_config, arch)
    opt = jax_adamw(lr=fr.LR, eps=eps)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jcfg, opt)
    batch = fr.batches(SyntheticLMData, jcfg.vocab_size)[0]
    jnew, _ = jax.jit(jax_build_train_step(jcfg, opt, grad_accum=accum))(
        jstate, batch)
    want = from_jax_train_state(jax_to_numpy(jnew), device="cpu")
    step = build_train_step(ff.config(get_config, arch),
                            adamw(lr=fr.LR, eps=eps), grad_accum=accum)
    got, _ = step(run["states"][name], shard_batch(batch, device="cpu"))
    at_eps = []
    for gm, wm, gp, wp in zip(leaves(got["opt"]["m"]),
                              leaves(want["opt"]["m"]),
                              leaves(got["params"]), leaves(want["params"])):
        assert (gm - wm).abs().max() <= GRAD_RTOL * wm.abs().max()
        moved = (gp - wp).abs() > PARAM_TOL
        at_eps += (wm[moved].abs() / 0.1).tolist()
    assert at_eps and max(at_eps) < EPS_BAND, at_eps


def _split_slots(gates, k, cap, bounds, own_only=False):
    """The port's slots of ``gates`` (G, S, E) with its flattened tokens
    split into runs at ``bounds`` (one simulated rank a run): each run
    on its grid, counts exchanged (``own_only``: the run's own alone),
    its slots placed back at its tokens → (G, S, k)."""
    g, s, e = gates.shape
    flat = gates.reshape(g * s, e)
    runs = list(zip(bounds[:-1], bounds[1:]))
    grids, counts = [], []
    for lo_tok, hi_tok in runs:
        g0, gl, lo = moe.run_grid(lo_tok, hi_tok - lo_tok, s)
        cells = torch.arange(lo, lo + hi_tok - lo_tok)
        grid = torch.zeros(gl * s, e).index_copy(0, cells,
                                                 flat[lo_tok:hi_tok])
        mask = torch.zeros(gl * s, dtype=torch.int32).index_fill(
            0, cells, 1).reshape(gl, s)
        grid = grid.reshape(gl, s, e)
        c = torch.zeros(g, k, e, dtype=torch.int32)
        c[g0:g0 + gl] = moe.level_counts(grid, k, mask)
        grids.append((g0, gl, cells, grid, mask))
        counts.append(c)
    out = torch.empty(g * s, k, dtype=torch.long)
    for r, ((lo_tok, hi_tok), (g0, gl, cells, grid, mask)) in enumerate(
            zip(runs, grids)):
        every = torch.stack([counts[r]] if own_only else counts)
        offs = moe.split_offsets(every, 0 if own_only else r)[g0:g0 + gl]
        slots, _ = moe._route(grid, k, cap, mask, offs)
        out[lo_tok:hi_tok] = slots.reshape(gl * s, k)[cells]
    return out.reshape(g, s, k)


@pytest.mark.parametrize("bounds", [(0, 37, 96), (0, 13, 40, 75, 96),
                                    (0, 5, 48, 49, 96)],
                         ids=["2 ranks", "4 ranks", "4 ranks at a group"])
def test_split_routing_equals_the_reference(bounds):
    """Two groups of 48 tokens, 8 experts top-2, capacity 8 (drops),
    split at uneven boundaries (across the groups' boundary too)."""
    k, cap = 2, 8
    rng = np.random.default_rng(len(bounds))
    logits = rng.standard_normal((2, 48, 8)).astype(np.float32)
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want, _ = jmoe._route(jnp.asarray(gates), k, cap)
    want = np.asarray(want)
    assert (want == 8 * cap).any()                    # tokens dropped
    t = torch.from_numpy(gates)
    np.testing.assert_array_equal(_split_slots(t, k, cap, bounds).numpy(),
                                  want)
    control = _split_slots(t, k, cap, bounds, own_only=True).numpy()
    assert not np.array_equal(control, want)


def test_aux_gradient_matches_one_process(run):
    for r in run["ranks"]:
        got, one = (np.asarray(x) for x in r["aux"])
        scale = np.abs(one).max()
        assert np.abs(got - one).max() <= AUX_TOL * scale, r["rank"]
        control = np.asarray(r["aux_control"])
        assert np.abs(control - one).max() > AUX_TOL * scale, r["rank"]


def _limit(r, name):
    """Two layers' whole bytes and the largest top-level leaf's."""
    return 2 * r[name]["bytes"]["layer"] + r[name]["bytes"]["top"]


@pytest.mark.parametrize("name", list(CASES))
def test_one_layer_whole_at_a_time(run, name):
    """The whole bytes gathered and alive at once stay within two layers
    (the forward's and a recompute's) and the largest top-level leaf;
    the recompute gathers every layer again (remat)."""
    n_layers = len(run["states"][name]["params"]["layers"])
    accum = CASES[name][3]
    for r in run["ranks"]:
        assert max(r[name]["peak"]) <= _limit(r, name), (
            r["rank"], r[name]["peak"])
        for calls in r[name]["calls"]:
            assert calls["regather"] >= n_layers * accum, calls


def test_gathering_the_tree_first_exceeds_the_limit(run):
    """The control: the whole tree gathered before the loss (its step's
    loss unchanged) holds more than the limit."""
    for r in run["ranks"]:
        control = r["tree_first"]
        assert control["peak"] > _limit(r, "moonshot f32"), r["rank"]
        assert _rel(control["loss"], r["moonshot f32"]["loss"][0]
                    ) <= METRIC_RTOL


class _Mesh:
    def __init__(self, d, m, rank):
        self.shape = {"data": d, "model": m}
        self.coords = {"data": rank // m, "model": rank % m}
        self.device = torch.device("cpu")


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_shard_batch_takes_its_block_of_each_micro_batch(family):
    """With grad_accum=2 a rank holds its block of each global
    micro-batch (rows [i·GB/2, (i+1)·GB/2)), in order."""
    rules = make_rules("train", family=family)
    batch = SyntheticLMData(512, 16, 8, seed=2).batch_at(0)
    blocks = 4 if family == "moe" else 2
    for rank in range(4):
        mesh = _Mesh(2, 2, rank)
        got = shard_batch(batch, mesh=mesh, grad_accum=2,
                          specs=batch_specs(batch, rules, mesh, 2))
        j = rank if family == "moe" else mesh.coords["data"]
        rows = 8 // blocks
        want = np.concatenate([np.arange(i * 8 + j * rows,
                                         i * 8 + (j + 1) * rows)
                               for i in range(2)])
        for k, v in batch.items():
            np.testing.assert_array_equal(got[k].numpy(), v[want])
        assert (got.micro, got.shards) == (2, blocks)


def test_moe_checkpoint_restores_on_one_process_and_1x2(run):
    saved = run["ranks"][0]["saved_state"]
    back = ckpt.restore(run["dir"] / "moe", run["states"]["moonshot int8"])
    flat_saved = leaves_with_path(saved)
    for (path, b), (_, s) in zip(leaves_with_path(back), flat_saved):
        np.testing.assert_array_equal(np.asarray(b), s, err_msg=str(path))
    for (path, b), (_, s) in zip(
            leaves_with_path(run["ranks"][0]["restored_1x2"]), flat_saved):
        np.testing.assert_array_equal(b, s, err_msg=str(path))
    assert len(leaves(saved)) == len(leaves(back))
    assert all(r["restored_same_mesh"] for r in run["ranks"])
