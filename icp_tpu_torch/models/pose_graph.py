"""SE(2) pose graph storage (the part of icp_tpu.models.pose_graph.PoseGraph2D
that the odometry path needs: nodes and edges). ``optimize`` and the
robust/loop-closure machinery wait for the loop-closure port (ROADMAP
Queue 1)."""
from __future__ import annotations

import numpy as np


class PoseGraph2D:
    """Nodes are [x, y, theta] vectors; an edge is (i, j, z_ij, omega_ij)."""

    def __init__(self):
        self._nodes: list[np.ndarray] = []
        self._edges_i: list[int] = []
        self._edges_j: list[int] = []
        self._edges_z: list[np.ndarray] = []
        self._edges_om: list[np.ndarray] = []

    def add_node(self, pose_vec) -> int:
        self._nodes.append(np.asarray(pose_vec, np.float32).copy())
        return len(self._nodes) - 1

    def add_edge(self, i, j, measurement, information=None):
        self._edges_i.append(int(i))
        self._edges_j.append(int(j))
        self._edges_z.append(np.asarray(measurement, np.float32).copy())
        self._edges_om.append(
            np.eye(3, dtype=np.float32) if information is None
            else np.asarray(information, np.float32).copy())

    @property
    def nodes(self):
        return self._nodes

    @property
    def n_nodes(self):
        return len(self._nodes)

    @property
    def n_edges(self):
        return len(self._edges_i)
