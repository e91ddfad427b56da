"""Pictures: Grad-CAM heatmaps and point-cloud renders (counterpart of
``fenet/viz``)."""

from fenet_torch.viz.gradcam import grad_cam
from fenet_torch.viz.render import get_ptcloud_img, render_clouds, save_cloud_png

__all__ = ["get_ptcloud_img", "grad_cam", "render_clouds", "save_cloud_png"]
