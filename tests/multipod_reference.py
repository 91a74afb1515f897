"""The reference's training under the multi-pod train rules, recorded for
the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/multipod_reference.py

writes ``tests/multipod_reference.json`` (~5 min). The setting is that of
``tests/fsdp_families_reference.py``: the reduced config in f32,
``adamw(lr=1e-2)``, ``build_train_step`` jitted under
``mesh_context(mesh, make_rules("train", multi_pod=True,
family=cfg.family))`` with the params placed by ``params_pspecs``, from
``init_train_state(PRNGKey(0))``, :data:`STEPS` steps on
``SyntheticLMData(vocab, 8, 32, seed=0)``'s batches (float embeddings of
``d_model`` for an embedding-input model), beside the same steps jitted
on one device. The mesh is (pod, data, model) of virtual CPU devices:
``seq_act`` puts the sequence on ``pod``, so each pod holds 16 of the 32
positions of its rows.

Beside each case's runs: the shard shapes a device holds of the params,
the moments and the batch's inputs and labels (``NamedSharding.
shard_shape`` of the reference dry run's ``params_pspecs`` /
``opt_pspecs`` / ``batch_specs``), in leaf order.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import fsdp_reference as fr

HERE = Path(__file__).resolve().parent
JSON_PATH = HERE / "multipod_reference.json"
# name → (arch, (pod, data, model))
CASES = {
    "qwen3": ("qwen3-0.6b", (2, 2, 2)),
    "moonshot": ("moonshot-v1-16b-a3b", (2, 2, 1)),
    "rwkv6": ("rwkv6-7b", (2, 2, 1)),
    "pixtral": ("pixtral-12b", (2, 2, 1)),
    "jamba": ("jamba-v0.1-52b", (2, 2, 1)),
}
AXES = ("pod", "data", "model")
STEPS = fr.STEPS


def config(get_config, arch: str):
    """The reduced config in f32, from either package's ``get_config``."""
    return get_config(arch, reduced=True, dtype="float32")


def batches(synthetic_lm_data, cfg) -> list:
    """The :data:`STEPS` batches as numpy (float embeddings for an
    embedding-input model), from either package's ``SyntheticLMData``."""
    data = synthetic_lm_data(cfg.vocab_size, fr.BATCH, fr.SEQ, seed=0,
                             embedding_dim=(cfg.d_model
                                            if cfg.embedding_inputs
                                            else None))
    return [data.batch_at(s) for s in range(STEPS)]


_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, numpy as np
jax.devices()
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.data import SyntheticLMData
from repro.launch import dryrun as dr
from repro.launch.mesh import make_test_mesh
from repro.optim import adamw
from repro.parallel.sharding import make_rules, mesh_context, params_pspecs
from repro.train import build_train_step, init_train_state
import fsdp_reference as fr
import multipod_reference as mr
from spec_reference import weight_digest
from torch_parity import jax_to_numpy


def flat(params):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(x, np.float32))
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]]


def run(step, state, data, mesh=None, rules=None):
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


def shard_shapes(tree, specs, mesh):
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)
    xs = jax.tree_util.tree_leaves(tree)
    ss = jax.tree_util.tree_leaves(specs, is_leaf=is_spec)
    assert len(xs) == len(ss), (len(xs), len(ss))
    return [list(NamedSharding(mesh, s).shard_shape(x.shape))
            for x, s in zip(xs, ss)]


cases = {{}}
for name, (arch, shape) in mr.CASES.items():
    cfg = mr.config(get_config, arch)
    data = mr.batches(SyntheticLMData, cfg)
    opt = adamw(lr=fr.LR)
    step = build_train_step(cfg, opt)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    single = run(step, state, data)
    mesh = make_test_mesh(shape, mr.AXES)
    rules = make_rules("train", multi_pod=True, family=cfg.family)
    specs = params_pspecs(state["params"], rules, mesh)
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state["params"], specs,
        is_leaf=lambda x: hasattr(x, "shape") and not isinstance(x, dict))
    moments = dr.opt_pspecs(specs, False)
    _, b_sh = dr.batch_specs(cfg, fr.BATCH, fr.SEQ, rules, mesh)
    blocks = dict(
        params=shard_shapes(state["params"], specs, mesh),
        m=shard_shapes(state["opt"]["m"], moments["m"], mesh),
        v=shard_shapes(state["opt"]["v"], moments["v"], mesh),
        **{{k: list(b_sh[k].shard_shape(np.shape(data[0][k])))
           for k in ("inputs", "labels")}})
    cases[name] = dict(
        state_sha256=weight_digest(jax_to_numpy(state)), single=single,
        sharded=run(step, {{**state, "params": sharded}}, data, mesh, rules),
        blocks=blocks)
    print(name, file=sys.stderr, flush=True)
print("MULTIPOD_JSON" + json.dumps(cases))
"""


def main() -> int:
    script = _RUN.format(src=str(HERE.parent / "src"), tests=str(HERE))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=3600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = [x for x in res.stdout.splitlines()
            if x.startswith("MULTIPOD_JSON")]
    if not line:
        print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
        return 1
    cases = json.loads(line[0][len("MULTIPOD_JSON"):])
    for name, c in cases.items():
        print(name, "single", c["single"]["loss"], c["single"]["grad_norm"],
              "sharded", c["sharded"]["loss"], c["sharded"]["grad_norm"])
    JSON_PATH.write_text(json.dumps(dict(
        axes=list(AXES), batch=[fr.BATCH, fr.SEQ], steps=STEPS, lr=fr.LR,
        samples=fr.SAMPLES,
        meshes={k: list(v[1]) for k, v in CASES.items()}, cases=cases),
        separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
