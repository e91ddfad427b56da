"""Geometry on tensors: ICP, cloud normalisation and the differentiable
silhouette projection (counterpart of ``fenet/geometry``)."""

from fenet_torch.geometry.icp import batched_icp
from fenet_torch.geometry.pointcloud import (
    average_pcl,
    normalize_to_unit_cube,
    outlier,
    preprocess_pcl_gt,
    rotate,
    scale2one,
)
from fenet_torch.geometry.projection import (
    apply_kernel,
    cont_proj,
    disc_proj,
    perspective_transform,
    project_silhouettes,
    world2cam,
)

__all__ = [
    "apply_kernel",
    "average_pcl",
    "batched_icp",
    "cont_proj",
    "disc_proj",
    "normalize_to_unit_cube",
    "outlier",
    "perspective_transform",
    "preprocess_pcl_gt",
    "project_silhouettes",
    "rotate",
    "scale2one",
    "world2cam",
]
