"""Interactive live map window (matplotlib; counterpart of
icp_tpu.utils.liveview).

The reference's live display (slam.py:416-452 window setup, slam.py:622-639
per-scan update): occupancy-probability image, trajectory polyline,
current-pose marker, configurable window size / colormap / clim / colours,
and the same zoom key bindings ('+'/'=' zoom in, '-' zoom out; 2D axes are
a parallel projection).

matplotlib is imported only inside the methods. ``LiveMapView.available()``
is False when matplotlib is not installed or there is no display; the
engine then writes periodic PNG snapshots (``engine.maybe_snapshot``), so
the same config runs anywhere.
"""
from __future__ import annotations

import os

import numpy as np


class LiveMapView:
    """Live occupancy-map window updated in place per processed scan."""

    @staticmethod
    def available() -> bool:
        """True when an interactive matplotlib backend can open a window."""
        try:
            import matplotlib
        except ImportError:
            return False
        if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                or os.name == "nt" or os.uname().sysname == "Darwin"):
            return False
        return matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "template",
        )

    def __init__(self, mapper, *, window_width=1400, window_height=1000,
                 cmap="gray", clim_min=0.0, clim_max=1.0,
                 background="black", trajectory_color="cyan",
                 pose_color="lime", pose_size=12):
        import matplotlib.pyplot as plt

        self.mapper = mapper
        dpi = 100.0
        self.fig, self.ax = plt.subplots(
            figsize=(window_width / dpi, window_height / dpi), dpi=dpi,
        )
        self.fig.canvas.manager.set_window_title("icp_tpu_torch — live map")
        self.fig.patch.set_facecolor(background)
        self.ax.set_facecolor(background)
        self.ax.set_aspect("equal")          # parallel projection
        extent = (mapper.min_x, mapper.max_x, mapper.min_y, mapper.max_y)
        self.img = self.ax.imshow(
            np.zeros((mapper.ny, mapper.nx), np.float32),
            cmap=cmap, vmin=clim_min, vmax=clim_max,
            origin="lower", extent=extent, interpolation="nearest",
        )
        (self.traj_line,) = self.ax.plot(
            [], [], color=trajectory_color, linewidth=2.0)
        (self.pose_pt,) = self.ax.plot(
            [], [], marker="o", markersize=pose_size * 0.75,
            color=pose_color, linestyle="none")
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        plt.show(block=False)

    def _on_key(self, event):
        # reference zoom bindings: plus/equal in, minus out (slam.py:442-450)
        if event.key in ("+", "="):
            self._zoom(0.9)
        elif event.key == "-":
            self._zoom(1.1)

    def _zoom(self, scale: float):
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        hx, hy = (x1 - x0) / 2 * scale, (y1 - y0) / 2 * scale
        self.ax.set_xlim(cx - hx, cx + hx)
        self.ax.set_ylim(cy - hy, cy + hy)
        self.fig.canvas.draw_idle()

    def update(self, trajectory: np.ndarray | None = None):
        """Refresh image/trajectory/pose and pump GUI events
        (reference slam.py:622-639)."""
        self.img.set_data(np.asarray(self.mapper.to_probability()))
        if trajectory is not None and len(trajectory):
            t = np.asarray(trajectory)
            self.traj_line.set_data(t[:, 0], t[:, 1])
            self.pose_pt.set_data(t[-1:, 0], t[-1:, 1])
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    def close(self):
        import matplotlib.pyplot as plt
        plt.close(self.fig)
