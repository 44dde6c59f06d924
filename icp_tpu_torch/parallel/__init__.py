"""icp_tpu.parallel on torch: the device mesh (mesh), the sharded sweep
(sweep_shard), the ray- and block-sharded grid updates (sharded_grid), the
distributed pose-graph solves (dist_pose_graph) and the scaled pipeline of
BASELINE config #5 over a mesh (scaled)."""
from icp_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh, set_virtual_devices, visible_devices,
)
from icp_tpu_torch.parallel.sweep_shard import sweep_scores_sharded  # noqa: F401
from icp_tpu_torch.parallel.dist_pose_graph import (  # noqa: F401
    gn_step_cg, gn_step_cg_sharded, gn_step_sharded, optimize_cg,
)
from icp_tpu_torch.parallel.sharded_grid import raytrace_update_sharded  # noqa: F401
from icp_tpu_torch.parallel.scaled import ScaledPipeline, ScaledStats  # noqa: F401
