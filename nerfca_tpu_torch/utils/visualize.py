"""3-D plot of the acquisition geometry (port of
``nerfca_tpu/utils/visualize.py``): the world frame, each viewpoint's
source position and frame, the detector outline, a few sample rays with
their near/far segment, and the volume's bounding box. ``matplotlib`` is
imported when the plot is made, with the Agg backend when it is saved."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from nerfca_tpu_torch.geometry.rays import detector_rays, pose_matrix

AXIS_COLORS = ("red", "green", "blue")


def visualize_geometry(view_points: Sequence[Sequence[float]], geo_info: dict,
                       volume_bounds: Optional[np.ndarray] = None, n_sample_rays: int = 3,
                       save_path: Optional[str] = None, ax_boundary: float = 15.0):
    """Plot the acquisition geometry; returns the matplotlib figure, closed
    once saved to ``save_path``. ``volume_bounds``: ``[[xmin, xmax], [ymin,
    ymax], [zmin, zmax]]`` of the reconstruction volume (a wireframe box)."""
    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    for setter in (ax.set_xlim3d, ax.set_ylim3d, ax.set_zlim3d):
        setter(-ax_boundary, ax_boundary)
    for i, axis in enumerate(np.eye(3)):  # the world frame
        ax.plot(*np.array([[0, 0, 0], axis]).T, c=AXIS_COLORS[i])
    if volume_bounds is not None:
        _draw_box(ax, np.asarray(volume_bounds))

    w, h = (int(v) for v in geo_info["nDetector"])
    dsd, dso = float(geo_info["DSD"]), float(geo_info["DSO"])
    near = float(geo_info.get("near_thresh", dso * 0.8))
    far = float(geo_info.get("far_thresh", dso * 1.2))
    for theta, phi in view_points:
        pose = pose_matrix(float(theta), float(phi), 0.0, dso)
        src = pose[:3, 3]
        ax.scatter(*src, c="black")
        ax.text(*src, f"{theta}-{phi}", size=12, color="k")
        for i, axis in enumerate(np.eye(3)):  # the source frame
            ax.plot(*np.array([src, pose[:3, :3] @ axis + src]).T, c=AXIS_COLORS[i])
        origins, dirs = (t.numpy() for t in detector_rays(float(theta), float(phi), 0.0,
                                                          geo_info))
        # the detector outline through its four corner rays at depth DSD
        corners = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1), (0, 0)]
        pts = np.array([origins[a, b] + dirs[a, b] * dsd for a, b in corners])
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], c="purple")
        for a in np.linspace(0, w - 1, n_sample_rays, dtype=int):
            o, d = origins[a, h // 2], dirs[a, h // 2]
            ax.plot(*np.array([o, o + d * dsd]).T, c="gray", alpha=0.3)
            ax.plot(*np.array([o + d * near, o + d * far]).T, c="orange")
    if save_path:
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
    return fig


def _draw_box(ax, bounds: np.ndarray) -> None:
    (x0, x1), (y0, y1), (z0, z1) = bounds
    corners = np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1) for z in (z0, z1)])
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6), (3, 7), (4, 5), (4, 6),
             (5, 7), (6, 7)]
    for a, b in edges:
        ax.plot(*np.array([corners[a], corners[b]]).T, c="teal", alpha=0.6)
