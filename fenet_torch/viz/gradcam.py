"""Grad-CAM over the generator's backbone (counterpart of
``fenet/viz/gradcam.py``; the reference's models/heatmap.py:43-126).

The reference hooks a module's forward and backward. Here the generator's
forward is re-entered from the backbone feature map (``Generator.decode``,
after ``RepVGG.features_from`` for a mid-network layer), and the target's
gradient with respect to that map gives the CAM weights directly. The maps
are NCHW, so the gradients are averaged over dims (2, 3) and the weighted
map summed over dim 1 (fenet's NHWC reduces over (1, 2) and -1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fenet_torch.models.generator import _nchw


def _l2_norm(pc3: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((pc3 ** 2).sum())


def grad_cam(model, image, target_fn=None, upsample_to: Optional[int] = 128,
             layer: Optional[str] = None) -> np.ndarray:
    """A (H, W) float32 heatmap in [0, 1] for one image (1, 128, 128, 3),
    raw 0..255, numpy or tensor.

    ``model`` is a branched ``Generator`` on any device; it runs with its
    BatchNorm in eval mode (the mode is restored after). ``target_fn(pc3)
    -> scalar`` defaults to the cloud's L2 norm, the reference driver's
    target. ``layer`` picks the feature map: a block name ('stage2_3'), a
    stage prefix ('stage2', that stage's last block), or None for the final
    map. Only the feature map takes a gradient; the forward runs with
    gradients on even inside the caller's ``inference_mode``.
    """
    if target_fn is None:
        target_fn = _l2_norm
    param = model.fc1.weight
    images = torch.as_tensor(image).to(param.device, torch.float32)
    backbone = model.RepVGG
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode(False), torch.enable_grad():
            x = _nchw(images, param.dtype)
            with torch.no_grad():
                fmap = (backbone.forward_features(x) if layer is None
                        else backbone.features_up_to(x, layer))
            fmap.requires_grad_(True)
            final = fmap if layer is None else backbone.features_from(fmap, layer)
            _, _, pc3 = model.decode(final, images)
            (grads,) = torch.autograd.grad(target_fn(pc3), fmap)
    finally:
        model.train(was_training)
    weights = grads.mean(dim=(2, 3), keepdim=True)  # GAP of the gradients
    cam = torch.relu((weights * fmap.detach()).sum(dim=1))[0]
    cam = (cam / (cam.max() + 1e-8)).cpu().numpy()
    if upsample_to is not None and cam.shape[0] != upsample_to:
        import cv2

        cam = cv2.resize(cam, (upsample_to, upsample_to))
    return cam


def overlay_heatmap(image: np.ndarray, cam: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """Blend a [0, 1] heatmap, JET-coloured, onto an (H, W, 3) 0..255 RGB
    image; uint8 RGB out (the reference's heatmap.py:110-121)."""
    import cv2

    heat = cv2.applyColorMap(np.uint8(255 * cam), cv2.COLORMAP_JET)
    heat = cv2.cvtColor(heat, cv2.COLOR_BGR2RGB).astype(np.float32)
    return np.clip(alpha * heat + (1 - alpha) * image, 0, 255).astype(np.uint8)


def save_cam_overlay(model, image, path: str, alpha: float = 0.4, target_fn=None,
                     layer: Optional[str] = None) -> np.ndarray:
    """The CAM of ``image`` ((1, H, W, 3) or (H, W, 3), 0..255) blended onto
    it and written to ``path`` as a PNG; returns the blended uint8 RGB
    array. ``layer`` as in :func:`grad_cam`."""
    import cv2

    img = np.asarray(image, np.float32)
    batched = img[None] if img.ndim == 3 else img
    cam = grad_cam(model, batched, target_fn=target_fn, upsample_to=batched.shape[1],
                   layer=layer)
    blended = overlay_heatmap(batched[0], cam, alpha=alpha)
    cv2.imwrite(path, cv2.cvtColor(blended, cv2.COLOR_RGB2BGR))
    return blended
