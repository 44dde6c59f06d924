"""SE(2) rigid-transform primitives on torch tensors (counterpart of
icp_tpu.utils.se2). Every function takes arbitrary leading batch dims.

``vec_to_pose_np`` / ``pose_to_vec_np`` are the same conversions on numpy
arrays, for host code (the pose graph's coarse level, the engine's edges).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def wrap_angle(a):
    """Wrap angle(s) to [-pi, pi) (floor-mod, as icp_tpu's ``wrap_angle``;
    its docstring says (-pi, pi], but the floor-mod gives [-pi, pi))."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def pose_to_vec(T):
    """(..., 3, 3) homogeneous matrix -> (..., 3) [x, y, theta]."""
    return torch.stack([T[..., 0, 2], T[..., 1, 2],
                        torch.atan2(T[..., 1, 0], T[..., 0, 0])], dim=-1)


def vec_to_pose(v):
    """(..., 3) [x, y, theta] -> (..., 3, 3) homogeneous matrix."""
    x, y, theta = v[..., 0], v[..., 1], v[..., 2]
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([torch.stack([c, -s, x], dim=-1),
                        torch.stack([s, c, y], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def pose_to_vec_np(T, dtype=np.float32):
    """Host form of ``pose_to_vec`` for one (3, 3) numpy matrix."""
    return np.array([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])], dtype)


def vec_to_pose_np(v, dtype=np.float64):
    """Host form of ``vec_to_pose`` for one [x, y, theta] vector."""
    c, s = np.cos(v[2]), np.sin(v[2])
    return np.array([[c, -s, v[0]], [s, c, v[1]], [0.0, 0.0, 1.0]], dtype)


def rotmat(theta):
    """2x2 rotation matrix/matrices: output shape ``theta.shape + (2, 2)``."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def pose_inverse(T):
    """Inverse of (..., 3, 3) SE(2) homogeneous matrices, closed form:
    [R^T, -R^T t; 0, 1]."""
    Rt = T[..., :2, :2].transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, T[..., :2, 2])
    return make_pose(Rt, ti)


def pose_compose(Ta, Tb):
    """Ta @ Tb for (..., 3, 3) homogeneous SE(2) matrices."""
    return torch.einsum("...ij,...jk->...ik", Ta, Tb)


def relative_pose_vec(Ti, Tj):
    """z_ij = vec(Ti^-1 @ Tj): the relative pose of j seen from i."""
    return pose_to_vec(pose_compose(pose_inverse(Ti), Tj))


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


def apply_rt(points, R, t):
    """points @ R^T + t for (..., N, D) points: the forward transform of
    ICP's (R, t)."""
    return torch.einsum("...nd,...ed->...ne", points, R) + t[..., None, :]


def apply_incremental_pose(global_pose, r, t):
    """global_pose @ inverse([r, t]): accumulate the inverse of ICP's
    forward transform into the global pose."""
    rT = r.transpose(-1, -2)
    ti = -(rT @ t[..., None])[..., 0]
    return global_pose @ make_pose(rT, ti)


def yaw_of_pose(T):
    """Yaw of a (..., 3, 3) pose matrix."""
    return torch.atan2(T[..., 1, 0], T[..., 0, 0])


def quat_to_yaw(qx, qy, qz, qw):
    """Yaw (rotation about z) of the quaternion (x, y, z, w)."""
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return torch.atan2(siny_cosp, cosy_cosp)
