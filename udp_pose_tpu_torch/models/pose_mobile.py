"""Pose nets on the mobile backbones: backbone → deconvolution or
pixel-shuffle head → final 1×1 (×3 channels for UDP offset).

Port of ``udp_pose_tpu/models/pose_mobile.py`` (reference
lib/models/pose_shufflenetv2_plus[_pixel_shuffle].py,
pose_shufflenetv2_10x[_pixel_shuffle].py,
pose_mobilenetv3_small[_pixel_shuffle].py, pose_mobilevit*_pixel_shuffle
.py).  Keys: ``backbone.*``, ``deconv_layers.*`` or ``decoder.*``,
``final_layer``; the nine registry names and their config readers are
the JAX package's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import DeconvHead, PixelShuffleDecoder
from .mobile import MobileNetV3Small, ShuffleNetV2, ShuffleNetV2Plus
from .mobilevit import MobileViT, MobileViTv2


class MobilePoseNet(nn.Module):
    """A mobile backbone, its head (``head`` "deconv" or
    "pixel_shuffle") and ``final_layer``.  Input NCHW (B, 3, H, W);
    output NCHW (B, C_out, H/4, W/4) float32 whatever the compute
    dtype."""

    def __init__(self, backbone: nn.Module, head: str = "deconv",
                 num_joints: int = 17, target_type: str = "gaussian",
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 num_deconv_kernels: Sequence[int] = (4, 4, 4),
                 deconv_with_bias: bool = False, start_channels: int = 256,
                 architecture: Sequence[int] = (512, 256, 128),
                 final_conv_kernel: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        #: compute dtype, as ``PoseHRNet.dtype``
        self.dtype = dtype
        self.head = head
        self.backbone = backbone
        if head == "deconv":
            self.deconv_layers = DeconvHead(backbone.out_channels,
                                            num_deconv_filters,
                                            num_deconv_kernels,
                                            deconv_with_bias)
            width = num_deconv_filters[-1]
        else:
            self.decoder = PixelShuffleDecoder(backbone.out_channels,
                                               start_channels, architecture)
            width = self.decoder.out_channels
        out_ch = num_joints * 3 if target_type == "offset" else num_joints
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = nn.Conv2d(width, out_ch, final_conv_kernel, 1, pad)

    def forward(self, x):
        x = self.backbone(x)
        x = self.deconv_layers(x) if self.head == "deconv" else \
            self.decoder(x)
        return self.final_layer(x).float()


def _common(cfg, backbone, head):
    extra = cfg.MODEL.EXTRA
    kw = dict(num_joints=cfg.MODEL.NUM_JOINTS,
              target_type=cfg.MODEL.TARGET_TYPE,
              final_conv_kernel=extra.FINAL_CONV_KERNEL,
              dtype=(torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16"
                     else torch.float32))
    if head == "deconv":
        kw.update(num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
                  num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
                  deconv_with_bias=extra.DECONV_WITH_BIAS)
    else:
        kw.update(start_channels=extra.get("START_CHANNELS", 256),
                  architecture=tuple(extra.get("ARCHITECTURE",
                                               (512, 256, 128))))
    return MobilePoseNet(backbone, head, **kw)


def shufflenetv2_plus(cfg, head):
    return _common(cfg, ShuffleNetV2Plus(
        cfg.MODEL.EXTRA.get("MODEL_SIZE", "Small")), head)


def shufflenetv2_10x(cfg, head):
    return _common(cfg, ShuffleNetV2(
        cfg.MODEL.EXTRA.get("MODEL_SIZE", "1.0x")), head)


def shufflenetv2_test(cfg):
    """The experimental all-in-one net of backbones/shufflenetv2_test.py
    (:117-206): ShuffleNetV2 1.0x, the pixel-shuffle decoder (1024 → 256,
    DUC 512/256/128) and a hard-coded 17×3-channel offset head, with the
    file's fixed hyperparameters, in the registered pose-wrapper layout.
    A config whose target type or joint count disagrees with that head
    raises, as in the JAX package."""
    if cfg.MODEL.TARGET_TYPE != "offset":
        raise ValueError(
            "shufflenetv2_test is a hardcoded offset-head net "
            "(reference backbones/shufflenetv2_test.py:195-201); set "
            "MODEL.TARGET_TYPE: offset in the config")
    if cfg.MODEL.NUM_JOINTS != 17:
        raise ValueError(
            "shufflenetv2_test's head is hardcoded 17*3 channels "
            "(reference backbones/shufflenetv2_test.py:195-201); a cfg "
            f"with NUM_JOINTS={cfg.MODEL.NUM_JOINTS} would silently "
            "build a non-reference head under the parity registry name")
    cfg = cfg.clone()
    cfg.defrost()
    cfg.MODEL.EXTRA.MODEL_SIZE = "1.0x"
    cfg.MODEL.EXTRA.START_CHANNELS = 256
    cfg.MODEL.EXTRA.ARCHITECTURE = [512, 256, 128]
    cfg.MODEL.EXTRA.FINAL_CONV_KERNEL = 1
    return _common(cfg, ShuffleNetV2("1.0x"), "pixel_shuffle")


def mobilenetv3_small(cfg, head):
    return _common(cfg, MobileNetV3Small(), head)


_MVIT_SIZES = {"s": "small", "xs": "x_small", "xxs": "xx_small"}


def mvit_mode(cfg):
    """MobileViT's size from ``EXTRA.MODEL_SIZE`` ('s' | 'xs' | 'xxs',
    pose_mobilevit_pixel_shuffle.py:27-34) or the ``MODEL.CONFIG`` file
    name."""
    size = cfg.MODEL.EXTRA.get("MODEL_SIZE", None)
    if size is not None:
        return _MVIT_SIZES.get(str(size), str(size))
    if cfg.MODEL.CONFIG:
        name = str(cfg.MODEL.CONFIG)
        return ("xx_small" if "xxs" in name else
                "x_small" if "xs" in name else "small")
    return "small"


def mvitv2_width(cfg):
    """MobileViTv2's width from ``EXTRA.MODEL_SIZE`` (0.5 / 0.75 / 1.0 in
    the reference yamls), else ``EXTRA.WIDTH_MULTIPLIER`` or the
    ``MODEL.CONFIG`` file name; 1.0 by default."""
    width = cfg.MODEL.EXTRA.get("MODEL_SIZE", None)
    try:
        width = None if width is None else float(width)
    except (TypeError, ValueError):
        width = None
    if width is None:
        width = cfg.MODEL.EXTRA.get("WIDTH_MULTIPLIER", None)
    if width is None and cfg.MODEL.CONFIG:
        name = str(cfg.MODEL.CONFIG)
        for cand in ("0.75", "0.5", "1.0"):
            if cand in name:
                return float(cand)
    return float(width if width is not None else 1.0)


def mobilevit(cfg):
    return _common(cfg, MobileViT(mvit_mode(cfg)), "pixel_shuffle")


def mobilevitv2(cfg):
    return _common(cfg, MobileViTv2(mvitv2_width(cfg)), "pixel_shuffle")
