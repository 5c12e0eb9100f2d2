"""PoseResNet (SimpleBaseline) in PyTorch, NCHW.

Port of ``udp_pose_tpu/models/resnet.py``.  Structure as in
deep_hrnet/lib/models/pose_resnet.py: stem :113-118, stages by
``RESNET_SPEC`` :254-260, the deconvolution head :124-130/:168-193, and
the final conv (×3 channels for UDP offset) :130-136.  ``psa=True``
(pose_resnet_psa) inserts ``PSA_s`` as ``deattn`` in every BasicBlock
(pose_resnet_psa.py:39,:51); Bottleneck nets take no attention.

Attribute names give the reference state_dict keys (``conv1``, ``bn1``,
``layer{1..4}.{i}.*``, ``deconv_layers.{i}``, ``final_layer``), so a
published ``.pth`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BasicBlock, BatchNorm2d, Bottleneck, DeconvHead,
                     max_pool_3x3_s2)
from .psa import PSA_s

RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(nn.Module):
    """ResNet backbone + deconvolution head + final conv.  Input NCHW
    (B, 3, H, W); output NCHW (B, C_out, H/4, W/4) float32 whatever the
    compute dtype."""

    def __init__(self, num_layers: int = 50, num_joints: int = 17,
                 target_type: str = "gaussian",
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 num_deconv_kernels: Sequence[int] = (4, 4, 4),
                 deconv_with_bias: bool = False, final_conv_kernel: int = 1,
                 psa: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        #: compute dtype, as ``PoseHRNet.dtype``
        self.dtype = dtype
        self.num_layers = num_layers
        self.psa = psa
        block_cls, layers = RESNET_SPEC[num_layers]
        attn = PSA_s if (psa and block_cls is BasicBlock) else None
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = max_pool_3x3_s2()
        inplanes = 64
        for li, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            seq = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                need_down = bi == 0 and (
                    s != 1 or inplanes != planes * block_cls.expansion)
                seq.append(block_cls(inplanes, planes, s,
                                     downsample=need_down, attention=attn))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))
        self.deconv_layers = DeconvHead(inplanes, num_deconv_filters,
                                        num_deconv_kernels, deconv_with_bias)
        out_ch = num_joints * 3 if target_type == "offset" else num_joints
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = nn.Conv2d(num_deconv_filters[-1], out_ch,
                                     final_conv_kernel, 1, pad)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.final_layer(self.deconv_layers(x)).float()


def pose_resnet_from_cfg(cfg, psa: bool = False):
    extra = cfg.MODEL.EXTRA
    dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
    return PoseResNet(
        num_layers=extra.NUM_LAYERS,
        num_joints=cfg.MODEL.NUM_JOINTS,
        target_type=cfg.MODEL.TARGET_TYPE,
        num_deconv_filters=tuple(extra.NUM_DECONV_FILTERS),
        num_deconv_kernels=tuple(extra.NUM_DECONV_KERNELS),
        deconv_with_bias=extra.DECONV_WITH_BIAS,
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
        psa=psa,
        dtype=dtype,
    )
