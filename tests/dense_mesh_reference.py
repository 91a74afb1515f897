"""The reference's dense slab on shards, recorded for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dense_mesh_reference.py

writes ``tests/dense_mesh_reference.json``. In a subprocess that sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (never set for the
suite: ``tests/conftest.py`` says why) it records:

* ``specs``: ``params_pspecs(params, make_rules("serve"), mesh)`` of the
  reduced :data:`SPEC_ARCHS` (``init_params(PRNGKey(0))``, whole and
  quantized to w8a8) on a (1, 2) mesh, leaf by leaf;
* ``decode``: for each case of :data:`CASES`, the reference's
  ``build_prefill_step`` / ``build_decode_step`` jitted under
  ``mesh_context(mesh, make_rules("decode"))`` on a (data, model) mesh
  of virtual CPU devices, the params placed by ``params_pspecs`` and the
  caches by ``launch/dryrun.py::cache_pspecs``, as the reference's dry run
  builds its prefill and decode cells: the greedy stream of
  :func:`prompt` over :data:`STEPS` tokens, the prefill's last logits and
  each decode step's logits (``forward`` jitted with the same shardings;
  those of the :data:`SEQ_CASE` and :data:`OVERRIDES` cases only), the
  caches' specs and the weights' SHA-256 (as the numpy tree the port
  converts). A case of :data:`OVERRIDES` updates the decode rules with
  its override (the hillclimb's B2: experts over model, ``expert_ff``
  over data).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
JSON_PATH = HERE / "dense_mesh_reference.json"
SPEC_ARCHS = ("jamba-v0.1-52b", "rwkv6-7b", "pixtral-12b", "musicgen-large")
SPEC_MESH = (1, 2)
# name → (arch, qmode, dtype, kv_dtype, (data, model)): qwen2-0.5b's one kv
# head does not divide 2, so its slab (float, and int8) splits along the
# sequence;
# moonshot's four experts split over data, its heads over model on (2, 2)
CASES = {
    "qwen2 seq-split": ("qwen2-0.5b", "none", "float32", None, (1, 2)),
    "qwen2 seq-split int8": ("qwen2-0.5b", "none", "float32", "int8",
                             (1, 2)),
    "moonshot f32 (2, 1)": ("moonshot-v1-16b-a3b", "none", "float32", None,
                            (2, 1)),
    "moonshot f32 (2, 2)": ("moonshot-v1-16b-a3b", "none", "float32", None,
                            (2, 2)),
    "moonshot w8a8 (2, 1)": ("moonshot-v1-16b-a3b", "w8a8", "bfloat16",
                             None, (2, 1)),
    "moonshot B2 f32 (2, 2)": ("moonshot-v1-16b-a3b", "none", "float32",
                               None, (2, 2)),
    "moonshot B2 w8a8 (2, 2)": ("moonshot-v1-16b-a3b", "w8a8", "bfloat16",
                                None, (2, 2)),
}
# the hillclimb's B2 rules (``repro.launch.hillclimb.cell_b``): the experts
# over model, expert_ff over data, on top of the decode rules
B2 = {"expert": ("model",), "expert_ff": ("data",)}
OVERRIDES = {"moonshot B2 f32 (2, 2)": B2, "moonshot B2 w8a8 (2, 2)": B2}
SEQ_CASE = "qwen2 seq-split"     # the cases whose every step's logits count
BATCH, PROMPT_LEN, STEPS = 4, 20, 6


def prompt(cfg, seed=7):
    """The batch's prompt token ids (B, S) int32, as numpy."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)
                        ).astype(np.int32)


def config(get_config, arch, qmode, dtype):
    """The reduced ``arch`` from either package's ``get_config``."""
    return get_config(arch, reduced=True, qmode=qmode, dtype=dtype)


def spec_list(spec) -> list:
    """A spec (PartitionSpec or the port's tuple) as a JSON list: None, an
    axis name, or a list of names, one entry a dim."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


_RUN = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
jax.devices()             # the 4 devices, before dryrun sets its own flags
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core.quant import QuantizedTensor
from repro.launch.dryrun import cache_pspecs
from repro.launch.mesh import make_test_mesh
from repro.models import init_params, quantize_params
from repro.models.transformer import forward
from repro.parallel.sharding import make_rules, mesh_context, params_pspecs
from repro.serving.engine import (build_decode_step, build_prefill_step,
                                  init_serve_caches)
import dense_mesh_reference as dm
from spec_reference import weight_digest
from torch_parity import jax_to_numpy

is_spec = lambda x: isinstance(x, (P, QuantizedTensor))


def flat_specs(specs):
    out = {{}}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=is_spec)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = ({{"q": dm.spec_list(s.q), "scale": dm.spec_list(s.scale)}}
                    if isinstance(s, QuantizedTensor) else dm.spec_list(s))
    return out


def placed(tree, specs, mesh):
    def put(x, s):
        if isinstance(s, QuantizedTensor):
            return QuantizedTensor(
                q=jax.device_put(x.q, NamedSharding(mesh, s.q)),
                scale=jax.device_put(x.scale, NamedSharding(mesh, s.scale)),
                bits=x.bits, shape=x.shape)
        return jax.device_put(x, NamedSharding(mesh, s))
    return jax.tree_util.tree_map(put, tree, specs, is_leaf=is_spec)


specs = {{}}
mesh = make_test_mesh(dm.SPEC_MESH)
for arch in dm.SPEC_ARCHS:
    cfg = dm.config(get_config, arch, "w8a8", None)
    p = init_params(jax.random.PRNGKey(0), cfg)
    for qmode, tree in (("none", p), ("w8a8", quantize_params(p, cfg,
                                                              "w8a8"))):
        specs[f"{{arch}}/{{qmode}}"] = flat_specs(params_pspecs(
            tree, make_rules("serve"), mesh))

cases = {{}}
for name, (arch, qmode, dtype, kv, shape) in dm.CASES.items():
    cfg = dm.config(get_config, arch, qmode, dtype)
    params = init_params(jax.random.PRNGKey(0), cfg)
    if qmode != "none":
        params = quantize_params(params, cfg, qmode)
    mesh = make_test_mesh(shape)
    rules = {{**make_rules("decode"), **dm.OVERRIDES.get(name, {{}})}}
    x = jnp.asarray(dm.prompt(cfg))
    max_len = dm.PROMPT_LEN + dm.STEPS
    with mesh_context(mesh, rules):
        p_shard = placed(params, params_pspecs(params, rules, mesh), mesh)
        caches = init_serve_caches(cfg, dm.BATCH, max_len, kv_dtype=kv)
        c_shard = cache_pspecs(caches, rules, mesh)
        caches = jax.tree_util.tree_map(
            lambda c, s: jax.device_put(c, s), caches, c_shard)
        prefill = jax.jit(build_prefill_step(cfg))
        decode = jax.jit(build_decode_step(cfg))
        logits_at = jax.jit(lambda p, c, t, pos: forward(
            p, cfg, t, caches=c, cache_pos=pos)[0][:, -1])
        last, caches = prefill(p_shard, x, caches)
        tok = jnp.argmax(last.astype(jnp.float32), axis=-1)[:, None].astype(
            jnp.int32)
        toks, logits = [tok], []
        for i in range(dm.STEPS - 1):
            pos = jnp.int32(dm.PROMPT_LEN + i)
            logits.append(np.asarray(logits_at(p_shard, caches, tok, pos),
                                     np.float32).tolist())
            tok, caches = decode(p_shard, caches, tok, pos)
            toks.append(tok)
    cspec = jax.tree_util.tree_map(lambda s: dm.spec_list(s.spec), c_shard,
                                   is_leaf=lambda s: isinstance(
                                       s, NamedSharding))
    first = cspec[[i for i in range(cfg.n_layers)
                   if cfg.mixer_of(i) == "attn"][0]]["attn"]
    cases[name] = dict(
        tokens=np.concatenate([np.asarray(t) for t in toks], 1).tolist(),
        prefill_logits=np.asarray(last, np.float32).tolist(),
        step_logits=(logits if name.startswith(dm.SEQ_CASE)
                     or name in dm.OVERRIDES else []),
        kv_spec=dict(k=first.k, k_scale=first.k_scale),
        weights_sha256=weight_digest(jax_to_numpy(params)))
    print(name, cases[name]["tokens"][0], file=sys.stderr, flush=True)
print("DENSE_MESH_JSON" + json.dumps(dict(specs=specs, decode=cases)))
"""


def main() -> int:
    script = _RUN.format(src=str(HERE.parent / "src"), tests=str(HERE))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=1800,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    line = [x for x in res.stdout.splitlines()
            if x.startswith("DENSE_MESH_JSON")]
    if not line:
        print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
        return 1
    got = json.loads(line[0][len("DENSE_MESH_JSON"):])
    for name, c in got["decode"].items():
        print(name, c["tokens"], c["kv_spec"])
    JSON_PATH.write_text(json.dumps(dict(
        spec_mesh=list(SPEC_MESH), batch=BATCH, prompt_len=PROMPT_LEN,
        steps=STEPS, **got), separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
