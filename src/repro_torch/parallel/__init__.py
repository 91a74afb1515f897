"""Distribution layer: logical-axis sharding rules, the mesh context, one
rank's shards, the collectives over a mesh, and flat FSDP's gather and
reduce of one layer at a time (``fsdp``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    PARTS,
    MeshCtx,
    RankShards,
    active_ctx,
    effective_model_shards,
    make_rules,
    mesh_context,
    params_pspecs,
    serve_tp,
    shard_params,
    sharded,
    spec_for,
)
