from icp_tpu_torch.services.lidar import LidarService, parse_lidar_line  # noqa: F401
from icp_tpu_torch.services.imu import IMUService  # noqa: F401
