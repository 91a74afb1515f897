"""Record the reference dry run's per-device argument bytes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_reference.py

For every arch × shape on the single-pod mesh (16 × 16) and on the
multi-pod mesh (2 × 16 × 16), and for the hillclimb's B2 (jamba-v0.1-52b
× decode_32k with the experts over model, ``expert_ff`` over data), the
reference's ``repro.launch.dryrun`` cell builders give the step's
abstract arguments and their shardings (``jax.eval_shape`` only: nothing
is lowered or compiled). Each leaf's per-device bytes are its ``NamedSharding.
shard_shape`` times its item size, summed by group (params, opt, step,
caches, inputs, labels, pos) into ``tests/dryrun_reference.json``, which
``tests/test_torch_dryrun.py`` holds the port's rank-0 bytes against.
The reference's cell qmodes are the sweep's: none for train, w8a8 for
serve. 512 virtual CPU devices, as the reference's dry run sets them
(~1 min).
"""
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "dryrun_reference.json"
# the hillclimb's B2 rules (``repro.launch.hillclimb.cell_b``)
B2_OVERRIDE = {"expert": ("model",), "expert_ff": ("data",)}


def main():
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, str(HERE.parent / "src"))
    import jax
    import numpy as np
    from jax.sharding import NamedSharding

    from repro.configs import REGISTRY, get_config
    from repro.configs.shapes import SHAPES, runnable
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_production_mesh
    from repro.parallel.sharding import make_rules, mesh_context

    assert len(jax.devices()) == 512, len(jax.devices())

    def shard_bytes(tree, shardings):
        xs = jax.tree_util.tree_leaves(tree)
        if shardings is None:                 # replicated
            return sum(int(np.prod(x.shape, dtype=np.int64))
                       * x.dtype.itemsize for x in xs)
        ss = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda s: isinstance(s, NamedSharding))
        if len(xs) != len(ss):
            raise ValueError(f"{len(xs)} leaves, {len(ss)} shardings: "
                             f"{ss[:4]}")
        total = 0
        for x, s in zip(xs, ss):
            shape = s.shard_shape(x.shape)
            total += int(np.prod(shape, dtype=np.int64)) * x.dtype.itemsize
        return total

    out = {}
    cells = [(arch, shape_name, multi_pod, None, "")
             for multi_pod in (False, True) for arch in REGISTRY
             for shape_name in SHAPES]
    cells.append(("jamba-v0.1-52b", "decode_32k", False, B2_OVERRIDE,
                  "B2_experts_model"))
    for arch, shape_name, multi_pod, override, tag in cells:
        mesh = make_production_mesh(multi_pod=multi_pod)
        shape = SHAPES[shape_name]
        qmode = "none" if shape.kind == "train" else "w8a8"
        cfg = get_config(arch, qmode=qmode)
        if not runnable(cfg.family, shape):
            continue
        rules = make_rules(mode=shape.kind, multi_pod=multi_pod,
                           family=cfg.family)
        rules.update(override or {})
        with mesh_context(mesh, rules):
            if shape.kind == "train":
                _, (state, batch), (s_sh, b_sh), _ = \
                    dr.build_train_cell(cfg, shape, mesh, rules)
                groups = {
                    "params": (state["params"], s_sh["params"]),
                    "opt": (state["opt"], s_sh["opt"]),
                    "step": (state["step"], s_sh["step"]),
                    "inputs": (batch["inputs"], b_sh["inputs"]),
                    "labels": (batch["labels"], b_sh["labels"])}
            elif shape.kind == "prefill":
                _, (params, inp, caches), (p_sh, i_sh, c_sh), _ = \
                    dr.build_prefill_cell(cfg, shape, mesh, rules,
                                          qmode)
                groups = {"params": (params, p_sh),
                          "inputs": (inp, i_sh),
                          "caches": (caches, c_sh)}
            else:
                _, (params, caches, tok, pos), \
                    (p_sh, c_sh, t_sh, _), _ = dr.build_decode_cell(
                        cfg, shape, mesh, rules, qmode)
                groups = {"params": (params, p_sh),
                          "caches": (caches, c_sh),
                          "inputs": (tok, t_sh),
                          "pos": (pos, None)}
        key = dr.cell_id(arch, shape_name, multi_pod, qmode,
                         tag=tag)
        out[key] = {g: shard_bytes(*v) for g, v in groups.items()}
        print(key, out[key], flush=True)
    OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT} ({len(out)} cells)")


if __name__ == "__main__":
    main()
