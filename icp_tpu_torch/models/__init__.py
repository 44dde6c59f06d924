from icp_tpu_torch.models.icp import (  # noqa: F401
    icp, icp_core, icp_large, identity_init, ICPResult,
)
from icp_tpu_torch.models.prealign import rotation_search, submap_rotation_search  # noqa: F401
from icp_tpu_torch.models.features import (  # noqa: F401
    extract_keypoints, compute_descriptors, match_descriptors,
    feature_based_alignment,
)
from icp_tpu_torch.models.occupancy import OccupancyGrid2D  # noqa: F401
from icp_tpu_torch.models.pose_graph import PoseGraph2D, optimize_dense  # noqa: F401
from icp_tpu_torch.models.slam_step import (  # noqa: F401
    make_slam_step, init_state, SlamState, StepOut,
)
