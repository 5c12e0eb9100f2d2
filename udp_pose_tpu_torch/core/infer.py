"""Inference pipeline: u8 crops → keypoints on the device.

Port of ``udp_pose_tpu/core/infer.py`` (and the normalisation of
``core/train.py``): normalise, cast to the compute dtype, the HRNet
forward with the flip test folded into the batch (``fold``) or run as a
second forward (``two_pass``), the flip un-permute, and the decode of
:mod:`..ops.decode`.  Public layouts are the JAX package's: (B, H, W, 3)
u8 crops in, (B, J, 2) preds, (B, J, 1) maxvals and a (B, C, Ht, Wt)
heatmap out; the model runs NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.decode import get_final_preds
from ..ops.flip import flip_back, flip_back_offset

# torchvision Normalize constants (deep_hrnet pose_engine.py:40-43)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# COCO flip pairs (deep_hrnet/lib/dataset/coco.py:91-92)
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                   (13, 14), (15, 16))
# MPII flip pairs (deep_hrnet/lib/dataset/mpii.py)
MPII_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))


def normalize_images(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8/float [0, 255] NHWC → normalised float32 NHWC.  ``mean`` and
    ``std``: 3 values, or float32 tensors already on the images' device
    (no host → device copy, which the host would wait for)."""
    x = images.float() / 255.0
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def cast_to_compute_dtype(model, x):
    """Cast normalised inputs to the model's compute dtype (bf16 models;
    a no-op for fp32 ones).  The first conv would cast anyway; casting
    here halves the bytes of the normalised batch and its flipped copy."""
    dtype = getattr(model, "dtype", torch.float32)
    return x.to(dtype) if dtype != x.dtype else x


def make_infer_fn(model, *, target_type: str = "gaussian",
                  flip_test: bool = True, post_process: bool = True,
                  kpd: float = 4.0, flip_pairs: Sequence = COCO_FLIP_PAIRS,
                  normalize: bool = True, flip_mode: str = "fold",
                  return_heatmaps: bool = True):
    """Build ``infer(images, center, scale) -> (preds, maxvals, hm|None)``.

    ``images``: (B, H, W, 3) RGB crops (numpy or torch) — raw [0, 255] if
    ``normalize`` else already normalised; ``center``/``scale`` (B, 2).
    Inputs move to the model's device; outputs are tensors there, with
    coords in source-image space.  ``flip_mode``: ``"fold"`` runs one
    forward on the 2B concat of the crops and their mirror images,
    ``"two_pass"`` two B-sized forwards; the sample-wise math is the same.
    """
    pairs = tuple(tuple(p) for p in flip_pairs)
    if flip_mode not in ("two_pass", "fold"):
        raise ValueError(f"flip_mode {flip_mode!r}: 'two_pass' or 'fold'")
    device = next(model.parameters()).device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)

    def forward(x_nhwc):
        # NHWC → NCHW view: channels-last strides, which the model keeps
        return model(x_nhwc.permute(0, 3, 1, 2)).float()

    @torch.inference_mode()
    def infer(images, center, scale):
        images = torch.as_tensor(images, device=device)
        center = torch.as_tensor(center, dtype=torch.float32, device=device)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
        x = normalize_images(images, mean, std) if normalize \
            else images.float()
        x = cast_to_compute_dtype(model, x)
        B = x.shape[0]
        if flip_test and flip_mode == "fold":
            x = torch.cat([x, x.flip(2)], dim=0)
        hm = forward(x)
        if flip_test:
            if flip_mode == "two_pass":
                hm_f = forward(x.flip(2))
            else:
                hm, hm_f = hm[:B], hm[B:]
            if target_type == "offset":
                hm_f = flip_back_offset(hm_f, pairs)
            else:
                hm_f = flip_back(hm_f, pairs)
            hm = (hm + hm_f) * 0.5
        preds, maxvals, _ = get_final_preds(
            hm, center, scale, target_type=target_type,
            post_process=post_process, kpd=kpd)
        return preds, maxvals, (hm if return_heatmaps else None)

    return infer


def make_infer_fn_from_cfg(model, cfg, flip_pairs=COCO_FLIP_PAIRS):
    return make_infer_fn(
        model,
        target_type=cfg.MODEL.TARGET_TYPE,
        flip_test=cfg.TEST.FLIP_TEST,
        post_process=cfg.TEST.POST_PROCESS,
        kpd=cfg.LOSS.KPD,
        flip_pairs=flip_pairs,
        flip_mode=cfg.TEST.get("FLIP_MODE", "fold"),
    )
