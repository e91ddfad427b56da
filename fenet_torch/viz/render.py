"""Point-cloud pictures with matplotlib's 3D scatter on the Agg backend
(counterpart of ``fenet/viz/render.py``; the reference's shapenet_img.py,
shapenet_img_edge.py and save_pix3d_img.py). Clouds are (N, 3) numpy
arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _array(cloud) -> np.ndarray:
    """A cloud as numpy: tensors are detached and copied to the host."""
    if hasattr(cloud, "detach"):
        cloud = cloud.detach().float().cpu().numpy()
    return np.asarray(cloud)


def _fig_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def get_ptcloud_img(ptcloud, elev: float = 30.0, azim: float = -45.0) -> np.ndarray:
    """Render an (N, 3) cloud to an (H, W, 3) uint8 RGB array."""
    plt = _pyplot()
    ptcloud = _array(ptcloud)
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    x, y, z = ptcloud[:, 0], ptcloud[:, 1], ptcloud[:, 2]
    ax.scatter(x, y, z, zdir="z", c=z, cmap="jet", s=2)
    ax.view_init(elev=elev, azim=azim)
    ax.axis("off")
    img = _fig_to_array(fig)
    plt.close(fig)
    return img


def save_cloud_png(ptcloud, path: str, **kw) -> None:
    """:func:`get_ptcloud_img` written to ``path``."""
    _pyplot().imsave(path, get_ptcloud_img(ptcloud, **kw))


def save_pix3d_cloud_png(ptcloud, path: str, scale: float = 0.45, azim: float = -45.0,
                         elev: float = -165.0, color: str = "r") -> None:
    """One cloud in the save_pix3d_img.py style (:101-126): fixed ±scale
    axes, red points, (y, z, x) axis order, azim -45, elev -165."""
    plt = _pyplot()
    p = _array(ptcloud)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.set_xlim(-scale, scale)
    ax.set_ylim(-scale, scale)
    ax.set_zlim(-scale, scale)
    ax.scatter(p[:, 1], p[:, 2], p[:, 0], c=color, s=5, depthshade=True)
    ax.axis("off")
    ax.view_init(azim=azim, elev=elev)
    fig.savefig(path)
    plt.close(fig)


def render_clouds(clouds: Dict[str, object], path: Optional[str] = None,
                  image: Optional[np.ndarray] = None) -> np.ndarray:
    """Side-by-side comparison (the gt against the multi-resolution
    predictions, shapenet_img.py's layout), returned as an RGB array and
    written to ``path`` if given; ``image`` prepends the input view."""
    plt = _pyplot()
    n = len(clouds) + (1 if image is not None else 0)
    fig = plt.figure(figsize=(4 * n, 4))
    col = 1
    if image is not None:
        ax = fig.add_subplot(1, n, col)
        ax.imshow(np.asarray(_array(image), np.float32) / 255.0)
        ax.set_title("input")
        ax.axis("off")
        col += 1
    for name, cloud in clouds.items():
        ax = fig.add_subplot(1, n, col, projection="3d")
        cloud = _array(cloud)
        ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2], c=cloud[:, 2], cmap="jet", s=2)
        ax.set_title(name)
        ax.axis("off")
        col += 1
    img = _fig_to_array(fig)
    if path is not None:
        plt.imsave(path, img)
    plt.close(fig)
    return img
