from icp_tpu_torch.ops.nn import (  # noqa: F401
    pairwise_sqdist, nn_query, nn_query_chunked, knn_query,
)
from icp_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_fixed  # noqa: F401
from icp_tpu_torch.ops.eig2 import eigh2x2, estimate_normals, compute_curvature  # noqa: F401
from icp_tpu_torch.ops.rigid import (  # noqa: F401
    p2p_solve_2d, p2p_solve_3d, p2l_solve_2d, solve3x3,
)
from icp_tpu_torch.ops.sweep import sweep_scores  # noqa: F401
from icp_tpu_torch.ops.ransac import ransac_align  # noqa: F401
from icp_tpu_torch.ops.raytrace import (  # noqa: F401
    bresenham_cells, raytrace_update, raytrace_update_batched,
)
from icp_tpu_torch.ops.densegrid import (  # noqa: F401
    CompactQueries, DenseGrid, DenseNNResult, bin_queries, build_dense_grid,
    cell_normals, compact_nn, dense_nn_query, grid_origin, scatter_results,
)
