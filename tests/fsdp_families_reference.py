"""The reference's sharded training of the MoE and recurrent families,
recorded for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/fsdp_families_reference.py

writes ``tests/fsdp_families_reference.json``. The setting is that of
``tests/fsdp_reference.py`` (the reference's ``_SPMD``): the reduced
config in f32, ``adamw(lr=1e-2)`` (one case with a larger eps),
``build_train_step`` jitted under ``mesh_context(mesh,
make_rules("train", family=cfg.family))`` with the
params placed by ``params_pspecs``, on a (2, 2) mesh of virtual CPU
devices, from ``init_train_state(PRNGKey(0))``, :data:`STEPS` steps on
``SyntheticLMData(vocab, 8, 32, seed=0)``'s batches, beside the same
steps jitted on one device; for each case of :data:`CASES`. The samples
and the digests are ``tests/fsdp_reference.py``'s.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import fsdp_reference as fr

HERE = Path(__file__).resolve().parent
JSON_PATH = HERE / "fsdp_families_reference.json"
EPS = 1e-8                # AdamW's default eps, in both packages
# name → (arch, quantize_moments, compress_grads, grad_accum, AdamW's eps).
# "moonshot accum 2, eps 1e-5" is "moonshot accum 2" with an eps at which
# no gradient element of these runs sits (the smallest that move an
# update there are ~1e-10..1e-7), so its update follows the gradient
# smoothly and a last-bit difference cannot swing it by a step.
CASES = {
    "moonshot f32": ("moonshot-v1-16b-a3b", False, None, 1, EPS),
    "moonshot int8": ("moonshot-v1-16b-a3b", True, "int8", 1, EPS),
    "moonshot accum 2": ("moonshot-v1-16b-a3b", False, None, 2, EPS),
    "moonshot accum 2, eps 1e-5": ("moonshot-v1-16b-a3b", False, None, 2,
                                   1e-5),
    "jamba f32": ("jamba-v0.1-52b", False, None, 1, EPS),
    "rwkv6 f32": ("rwkv6-7b", False, None, 1, EPS),
}
STEPS = fr.STEPS


def config(get_config, arch: str):
    """The reduced config in f32, from either package's ``get_config``."""
    return get_config(arch, reduced=True, dtype="float32")


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
import fsdp_families_reference as ff
import fsdp_reference as fr
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


cases = {{}}
for name, (arch, qm, cg, accum, eps) in ff.CASES.items():
    cfg = ff.config(get_config, arch)
    data = fr.batches(SyntheticLMData, cfg.vocab_size)
    opt = adamw(lr=fr.LR, quantize_moments=qm, eps=eps)
    step = build_train_step(cfg, opt, grad_accum=accum, compress_grads=cg)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    single = run(step, state, data)
    mesh = make_test_mesh(fr.MESH)
    rules = make_rules("train", family=cfg.family)
    specs = params_pspecs(state["params"], rules, mesh)
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state["params"], specs,
        is_leaf=lambda x: hasattr(x, "shape") and not isinstance(x, dict))
    cases[name] = dict(
        state_sha256=weight_digest(jax_to_numpy(state)), single=single,
        sharded=run(step, {{**state, "params": sharded}}, data, mesh, rules))
    print(name, file=sys.stderr, flush=True)
print("FAMILIES_JSON" + json.dumps(cases))
"""


def main() -> int:
    script = _RUN.format(src=str(HERE.parent / "src"), tests=str(HERE))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=1800,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = [x for x in res.stdout.splitlines()
            if x.startswith("FAMILIES_JSON")]
    if not line:
        print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
        return 1
    cases = json.loads(line[0][len("FAMILIES_JSON"):])
    for name, c in cases.items():
        print(name, "single", c["single"]["loss"], c["single"]["grad_norm"],
              "sharded", c["sharded"]["loss"], c["sharded"]["grad_norm"])
    JSON_PATH.write_text(json.dumps(dict(
        mesh=list(fr.MESH), batch=[fr.BATCH, fr.SEQ], steps=STEPS, lr=fr.LR,
        samples=fr.SAMPLES, cases=cases), separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
