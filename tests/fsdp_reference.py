"""The reference's sharded training numbers, recorded for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fsdp_reference.py

writes ``tests/fsdp_reference.json`` (~1 min). The setting is that of the
reference's own sharded test (``tests/test_distribution.py``'s ``_SPMD``):
the reduced qwen3-0.6b in f32, ``adamw(lr=1e-2)``, ``build_train_step``
jitted under ``mesh_context(mesh, make_rules("train", family="dense"))``
with the params placed by ``params_pspecs``, on a (2, 2) mesh of virtual
CPU devices, from ``init_train_state(PRNGKey(0))``; here for
:data:`STEPS` steps on ``SyntheticLMData(vocab, 8, 32, seed=0)``'s
batches, for each case of :data:`CASES` (f32 moments; int8 moments with
int8 gradient compression), beside the same steps jitted on one device.

Per case and run: every step's loss and grad_norm, and after every step
each parameter leaf's values at fixed flat indices (:func:`sample_indices`)
keyed by its tree path; with a SHA-256 of the initial state as the numpy
tree the port converts. The virtual devices need
``--xla_force_host_platform_device_count`` before JAX starts, so the
recorder runs the reference in a subprocess (as ``_SPMD`` does), and the
port's test reads this file after checking the digest: it runs no
multi-device JAX itself.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
JSON_PATH = HERE / "fsdp_reference.json"
ARCH = "qwen3-0.6b"
MESH = (2, 2)
BATCH, SEQ = 8, 32
STEPS = 3
LR = 1e-2
SAMPLES = 16
# (name, quantize_moments, compress_grads)
CASES = (("f32", False, None), ("int8", True, "int8"))


def config(get_config):
    """The reduced model in f32, from either package's ``get_config``."""
    return get_config(ARCH, reduced=True, dtype="float32")


def batches(synthetic_lm_data, vocab: int) -> list:
    """The :data:`STEPS` batches as numpy, from either package's
    ``SyntheticLMData`` (the port's yields the reference's bit for bit)."""
    data = synthetic_lm_data(vocab, BATCH, SEQ, seed=0)
    return [data.batch_at(s) for s in range(STEPS)]


def sample_indices(size: int, leaf_no: int) -> list:
    """:data:`SAMPLES` fixed flat indices of a leaf (all of a smaller one)."""
    rng = np.random.default_rng(leaf_no)
    return sorted(rng.choice(size, min(size, SAMPLES), replace=False).tolist())


def samples(flat_leaves) -> dict:
    """[(path key, numpy leaf)] → {key: [values at the fixed indices]}."""
    return {key: np.asarray(a, np.float64).reshape(-1)[
        sample_indices(a.size, no)].tolist()
        for no, (key, a) in enumerate(flat_leaves)}


_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.data import SyntheticLMData
from repro.launch.mesh import make_test_mesh
from repro.optim import adamw
from repro.parallel.sharding import make_rules, mesh_context, params_pspecs
from repro.train import build_train_step, init_train_state
import fsdp_reference as fr
from spec_reference import weight_digest
from torch_parity import jax_to_numpy

cfg = fr.config(get_config)
data = fr.batches(SyntheticLMData, cfg.vocab_size)


def flat(params):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(x, np.float32))
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]]


def run(step, state, mesh=None, rules=None):
    out = dict(loss=[], grad_norm=[], params=[])
    fn = jax.jit(step)
    for b in data:
        if mesh is None:
            state, m = fn(state, b)
        else:
            with mesh_context(mesh, rules):
                state, m = fn(state, b)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(fr.samples(flat(state["params"])))
    return out


cases = {{}}
for name, qm, cg in fr.CASES:
    opt = adamw(lr=fr.LR, quantize_moments=qm)
    step = build_train_step(cfg, opt, compress_grads=cg)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    single = run(step, state)
    mesh = make_test_mesh(fr.MESH)
    rules = make_rules("train", family="dense")
    specs = params_pspecs(state["params"], rules, mesh)
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state["params"], specs,
        is_leaf=lambda x: hasattr(x, "shape") and not isinstance(x, dict))
    cases[name] = dict(
        state_sha256=weight_digest(jax_to_numpy(state)), single=single,
        sharded=run(step, {{**state, "params": sharded}}, mesh, rules))
print("FSDP_JSON" + json.dumps(cases))
"""


def main() -> int:
    script = _RUN.format(src=str(HERE.parent / "src"), tests=str(HERE))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=900,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = [x for x in res.stdout.splitlines() if x.startswith("FSDP_JSON")]
    if not line:
        print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
        return 1
    cases = json.loads(line[0][len("FSDP_JSON"):])
    for name, c in cases.items():
        print(name, "single", c["single"]["loss"], "sharded",
              c["sharded"]["loss"])
    JSON_PATH.write_text(json.dumps(dict(
        arch=ARCH, mesh=list(MESH), batch=[BATCH, SEQ], steps=STEPS, lr=LR,
        samples=SAMPLES, cases=cases), separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
