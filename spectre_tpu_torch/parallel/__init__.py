"""The mesh prove path: one controller, an explicit device list (the port
of `spectre_tpu/parallel/`).

One Python process runs the prover; a ShardingPlan places each shard's
work on its torch device (a device may hold several shards) and counts the
bytes shards exchange. On the plan ride the sharded MSM (rows along
"data", windows along "win"), the batched MSM (whole MSMs along the flat
batch axis), the sharded NTT (the Bailey split, one all-to-all) and the
sharded quotient (extended columns row-sharded over every device). Every
shard body runs the single-device kernels: K1, K2, K2b, K3 and K4 (K7 and
K8 under their knobs).
"""

from .mesh import MeshShapeError, default_mesh, make_mesh  # noqa: F401
from .plan import ShardingPlan, current_plan, plan_for_mesh  # noqa: F401
