"""The run-to-run spread of phase 14's moonshot entry on the card: the
entry's ranks run N times from the seed's state against one process, and
one process runs twice.

    python3 tools/fsdp_moe_spread.py [N]

Prints, for each repeat, the relative loss gap to one process at every
step, the share of layer 0's expert picks that differ from one process's
at every step and the zeroed-update control's gap; then one process's
losses from two runs. Needs a CUDA card; imports nothing of JAX.
"""
import os
import sys
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"


def rank(mesh, job):
    return cs.fsdp_family_rank(cs.family_mesh(mesh, ARCH),
                               dict(job, arch=ARCH))


def main(argv=None) -> int:
    n = int((argv or sys.argv[1:] or ["3"])[0])
    cs.build.build_all()
    one = cs.family_one_process(ARCH, cs.SEED)
    for rep in range(n):
        with tempfile.TemporaryDirectory() as d:
            ranks = spawn_ranks(rank, 2, init_dir=d, backend="gloo",
                                device="cuda", args=(dict(seed=cs.SEED,
                                                          dir=d),),
                                timeout=600, shape=cs.FSDP_MESH)
        r0 = ranks[0]
        gaps = [cs._rel_gap(a, b) for a, b in zip(r0["loss"], one["loss"])]
        share = [cs.route_share(one["routes"][s], ranks,
                                lambda r: r["routes"][s], True)
                 for s in range(cs.FSDP_STEPS)]
        print("rep", rep, "loss gaps", gaps, "expert picks apart", share,
              "control_update",
              cs._rel_gap(r0["control_update"], one["loss"][1]), flush=True)
    again = cs.family_one_process(ARCH, cs.SEED)
    print("one process twice: loss", one["loss"], again["loss"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
