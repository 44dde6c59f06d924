"""Single-device part of icp_tpu.parallel: the matrix-free PCG pose-graph
solve (dist_pose_graph). The mesh, sharded sweeps and grids, the Schur
solve and the scaled pipeline are ROADMAP Queue 1 work."""
from icp_tpu_torch.parallel.dist_pose_graph import (  # noqa: F401
    gn_step_cg, optimize_cg,
)
