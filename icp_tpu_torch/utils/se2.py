"""SE(2) rigid-transform primitives on torch tensors (counterpart of
icp_tpu.utils.se2). Every function takes arbitrary leading batch dims."""
from __future__ import annotations

import math

import torch


def wrap_angle(a):
    """Wrap angle(s) to [-pi, pi) (floor-mod, as icp_tpu's ``wrap_angle``)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def rotmat(theta):
    """2x2 rotation matrix/matrices: output shape ``theta.shape + (2, 2)``."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def make_pose(R, t):
    """Assemble a 3x3 homogeneous matrix from R (..., 2, 2) and t (..., 2)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 3))
    return torch.cat([top, bottom], dim=-2)


def transform_points(points, pose):
    """Apply a 3x3 homogeneous pose to (..., N, 2) points."""
    R = pose[..., :2, :2]
    t = pose[..., :2, 2]
    return points @ R.transpose(-1, -2) + t[..., None, :]


def apply_incremental_pose(global_pose, r, t):
    """global_pose @ inverse([r, t]): accumulate the inverse of ICP's
    forward transform into the global pose."""
    rT = r.transpose(-1, -2)
    ti = -(rT @ t[..., None])[..., 0]
    return global_pose @ make_pose(rT, ti)


def yaw_of_pose(T):
    """Yaw of a (..., 3, 3) pose matrix."""
    return torch.atan2(T[..., 1, 0], T[..., 0, 0])
