"""Log-odds occupancy grid on the device (counterpart of
icp_tpu.models.occupancy.OccupancyGrid2D).

Export formats (CSV / NPY probability grids) match the reference
(utilities/mapping.py:183-187).
"""
from __future__ import annotations

import numpy as np
import torch

from icp_tpu_torch.ops.raytrace import raytrace_update
from icp_tpu_torch.utils import spans


def _uploads(*arrays) -> int:
    """Host arrays among ``arrays`` (None aside): each is one copy to the
    device, a sync on a card."""
    return sum(a is not None and not isinstance(a, torch.Tensor)
               for a in arrays)


def world_to_cells(xy, min_x, min_y, resolution):
    """World coordinates (..., 2) -> integer grid cells (..., 2) as (ix, iy),
    computed in f32 as icp_tpu computes them."""
    spans.count("sync.map.grid_min")
    grid_min = torch.tensor([min_x, min_y], dtype=torch.float32,
                            device=xy.device)
    return torch.floor((xy - grid_min) * np.float32(1.0 / resolution)
                       ).to(torch.int64)


class OccupancyGrid2D:
    """2D probabilistic occupancy grid with log-odds ray tracing.

    The grid covers [min_x, max_x) x [min_y, max_y) at ``resolution``
    metres per cell; log-odds increments come from p_hit/p_miss and are
    clamped to [log_odds_min, log_odds_max]. ``log_odds`` is a (ny, nx) f32
    tensor on ``device`` and is updated in place.
    """

    def __init__(
        self,
        min_x, max_x, min_y, max_y,
        resolution=0.1,
        p_hit=0.7,
        p_miss=0.4,
        log_odds_min=-5.0,
        log_odds_max=5.0,
        max_ray_cells: int = 2048,
        free_cells_cap: int | None = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OccupancyGrid2D(device='cuda') but CUDA is "
                               "not available; pass device='cpu' explicitly")
        self.min_x = float(min_x)
        self.max_x = float(max_x)
        self.min_y = float(min_y)
        self.max_y = float(max_y)
        self.resolution = float(resolution)
        self.nx = int(np.ceil((self.max_x - self.min_x) / self.resolution))
        self.ny = int(np.ceil((self.max_y - self.min_y) / self.resolution))
        self.l_hit = float(np.log(p_hit / (1.0 - p_hit)))
        self.l_miss = float(np.log(p_miss / (1.0 - p_miss)))
        self.log_odds_min = float(log_odds_min)
        self.log_odds_max = float(log_odds_max)
        self.max_ray_cells = int(max_ray_cells)
        # icp_tpu's capacity of its sorted free-cell scatter. Kept so the
        # same constructor call works; the paint here needs no capacity.
        self.free_cells_cap = (None if free_cells_cap is None
                               else int(free_cells_cap))
        self.log_odds = torch.zeros((self.ny, self.nx), dtype=torch.float32,
                                    device=self.device)

    def update_scan(self, origin_xy, hit_points, mask=None):
        """Trace rays from origin to each (valid) hit; update log-odds.

        origin_xy (2,) world coords; hit_points (N, 2) world coords (array or
        tensor); mask (N,) bool (None = all valid).
        """
        spans.count("sync.map.upload", _uploads(hit_points, origin_xy, mask))
        hits = torch.as_tensor(hit_points, dtype=torch.float32,
                               device=self.device)
        origin = torch.as_tensor(origin_xy, dtype=torch.float32,
                                 device=self.device)
        if mask is None:
            mask = torch.ones(hits.shape[0], dtype=torch.bool, device=self.device)
        else:
            mask = torch.as_tensor(mask, device=self.device)
        grid = (self.min_x, self.min_y, self.resolution)
        raytrace_update(
            self.log_odds, world_to_cells(origin, *grid),
            world_to_cells(hits, *grid), mask,
            self.l_hit, self.l_miss, self.log_odds_min, self.log_odds_max,
            max_steps=self.max_ray_cells,
        )

    def replay(self, origins, hits, masks):
        """Rebuild the grid from K keyframes: a zeroed grid, then one
        ``raytrace_update`` per keyframe in order, each with its own clamp
        (the reference's rebuild loop, slam.py:271-277, and icp_tpu's
        lax.scan replay).

        origins (K, 2) and hits (K, N, 2) world coordinates; masks (K, N)
        bool, where an all-False row is a padding keyframe (a no-op, so it
        is skipped). The replayed grid is a NEW tensor bound to
        ``log_odds``: a tensor that aliased the old grid (the fused state's)
        keeps the old values, as icp_tpu's replay leaves its state's grid.
        """
        spans.count("sync.map.upload", _uploads(masks, origins, hits))
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        origins = torch.as_tensor(origins, dtype=torch.float32,
                                  device=self.device)
        hits = torch.as_tensor(hits, dtype=torch.float32, device=self.device)
        grid = (self.min_x, self.min_y, self.resolution)
        lo = torch.zeros((self.ny, self.nx), dtype=torch.float32,
                         device=self.device)
        spans.count("sync.map.replay_rows", 2)     # nonzero, then the list
        for k in torch.nonzero(masks.any(dim=1)).flatten().tolist():
            raytrace_update(
                lo, world_to_cells(origins[k], *grid),
                world_to_cells(hits[k], *grid), masks[k],
                self.l_hit, self.l_miss, self.log_odds_min,
                self.log_odds_max, max_steps=self.max_ray_cells)
        self.log_odds = lo

    def reset(self):
        """Back to unexplored (reference mapping.py:143-145), as a new
        tensor (see ``replay``)."""
        self.log_odds = torch.zeros((self.ny, self.nx), dtype=torch.float32,
                                    device=self.device)

    # ── probability / display (reference mapping.py:150-160) ────────────
    def to_probability(self):
        return torch.sigmoid(self.log_odds).cpu().numpy()

    def to_display(self):
        """Display map: 1 - p, with unexplored cells white (1.0) and free
        cells light grey (0.85). One device read, then numpy."""
        lo = self.log_odds.cpu().numpy()
        display = 1.0 - (1.0 / (1.0 + np.exp(-lo)))
        display[lo == 0.0] = 1.0
        display[lo < 0.0] = 0.85
        return display

    # ── export (reference mapping.py:183-187) ────────────────────────────
    def save_csv(self, file_path):
        np.savetxt(file_path, self.to_probability(), delimiter=",")

    def save_npy(self, file_path):
        np.save(file_path, self.to_probability())

    def save_png(self, file_path, trajectory=None):
        """Headless map render: greyscale PNG of the display map, y up,
        with the trajectory (N, 2) overlaid in red where given."""
        from icp_tpu_torch.utils.raster import COLORS, write_png
        img8 = (self.to_display() * 255).astype(np.uint8)[::-1]  # y-up
        img = np.stack([img8] * 3, axis=-1)
        if trajectory is not None and len(trajectory):
            t = np.asarray(trajectory)
            ix = np.clip(((t[:, 0] - self.min_x) / self.resolution).astype(int),
                         0, self.nx - 1)
            iy = np.clip(((t[:, 1] - self.min_y) / self.resolution).astype(int),
                         0, self.ny - 1)
            img[(self.ny - 1) - iy, ix] = COLORS["red"]
        write_png(file_path, img)
        return True
