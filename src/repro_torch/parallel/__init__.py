"""Parallelism over ``torch.distributed``: the counterpart of
``repro/parallel/`` -- the sharding rules and the serving slot mesh
(``sharding``), the int8 error-feedback all-reduce (``compress``), the
version shims (``compat``) and the multi-rank launcher (``ranks``)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    MeshRules,
    ShardingCtx,
    make_rules,
    param_pspecs,
)
