"""Single-device part of icp_tpu.parallel: the matrix-free PCG pose-graph
solve (dist_pose_graph) and the scaled pipeline of BASELINE config #5 on
one device (scaled). The mesh, the sharded sweeps and grids and the Schur
solve are ROADMAP Queue 1 work."""
from icp_tpu_torch.parallel.dist_pose_graph import (  # noqa: F401
    gn_step_cg, optimize_cg,
)
from icp_tpu_torch.parallel.scaled import ScaledPipeline, ScaledStats  # noqa: F401
