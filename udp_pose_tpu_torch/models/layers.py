"""Shared building blocks: conv/BN/ReLU, the residual blocks, the
SimpleBaseline max-pool and deconvolution head, and the pixel-shuffle
decoder of the mobile nets.

Port of ``udp_pose_tpu/models/layers.py`` in NCHW.  Attribute names are
the reference torch ones (deep_hrnet/lib/models/pose_hrnet.py:29-101:
``conv1``/``bn1``/.../``downsample.0``/``downsample.1``, the PSA insert
``deattn``; pose_resnet.py:168-193: ``deconv_layers.{i}``;
decoders/pixelshuffle.py: ``conv_compress``/``duc.{i}.conv``/
``duc.{i}.bn``), so a
published ``.pth`` and the JAX package's bridged variables load with
``strict=True``.

BatchNorm (:class:`BatchNorm2d`): eps 1e-5, torch momentum 0.1 (flax's
0.9 in the other convention); in train mode it updates the running
variance with the biased batch variance, as flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1  # torch convention: ema = (1-m)*ema + m*batch  (flax 0.9)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-stat update in train mode.

    flax ``nn.BatchNorm`` (``udp_pose_tpu/models/layers.py:38``) folds
    the *biased* batch variance into ``running_var``; torch folds the
    unbiased one, n/(n-1) larger (8/7 on a 2×2 map at B=2).  Train mode
    normalises with ``torch.native_batch_norm`` on the batch statistics
    and takes the variance from the inverse std that it returns,
    ``1/invstd² - eps``: no second pass over the activation.  Eval mode
    and the state-dict keys are those of ``nn.BatchNorm2d``.
    """

    def __init__(self, num_features, eps=1e-5, momentum=BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        out, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            dt = self.running_mean.dtype
            self.running_mean.lerp_(mean.to(dt), self.momentum)
            self.running_var.lerp_(invstd.to(dt).pow(-2).sub_(self.eps),
                                   self.momentum)
            self.num_batches_tracked.add_(1)
        return out


class ConvBN(nn.Sequential):
    """Conv → BatchNorm (+ optional ReLU) as ``Sequential(conv, bn[, relu])``,
    i.e. the reference's ``.0``/``.1`` keys (transitions, fuse chains,
    downsample branches)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True):
        pad = (kernel - 1) // 2
        layers = [nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=False),
                  BatchNorm2d(out_ch)]
        if relu:
            layers.append(nn.ReLU(inplace=True))
        super().__init__(*layers)


def _conv_bn(in_ch, out_ch, kernel, stride):
    pad = (kernel - 1) // 2
    return (nn.Conv2d(in_ch, out_ch, kernel, stride, pad, bias=False),
            BatchNorm2d(out_ch))


class BasicBlock(nn.Module):
    """3x3-3x3 residual block (pose_hrnet.py:29-59); ``attention`` (a
    module class taking ``planes``, e.g. ``PSA_s``) is inserted as
    ``deattn`` between conv1 and conv2 (pose_hrnet_psa.py:37,:49)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, attention=None):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 3, stride)
        self.deattn = None if attention is None else attention(planes)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, 1)
        self.downsample = (ConvBN(inplanes, planes, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        if self.deattn is not None:
            out = self.deattn(out)
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1-3x3-1x1 residual block, expansion 4 (pose_hrnet.py:62-101);
    ``attention`` is inserted as ``attn`` between conv2 and conv3."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, attention=None):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(inplanes, planes, 1, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride)
        self.attn = None if attention is None else attention(planes)
        self.conv3, self.bn3 = _conv_bn(planes, planes * 4, 1, 1)
        self.downsample = (ConvBN(inplanes, planes * 4, 1, stride, relu=False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.attn is not None:
            out = self.attn(out)
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


def max_pool_3x3_s2():
    """torch ``MaxPool2d(3, 2, padding=1)``, the ResNet stem's pool."""
    return nn.MaxPool2d(3, 2, 1)


# ConvTranspose2d (padding, output_padding) by kernel size, each an exact
# ×2 (pose_resnet.py:156-166).  The JAX package's flax head pads "SAME",
# which is the same geometry for kernels 4 and 2, and for kernel 3 one
# pixel later: its output is this one's shifted down and right by one.
DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class DeconvHead(nn.Sequential):
    """SimpleBaseline head: N × (ConvTranspose2d stride 2 + BatchNorm +
    ReLU) as one ``Sequential``, i.e. the reference's
    ``deconv_layers.{3i}`` / ``.{3i + 1}`` keys (pose_resnet.py:168-193)."""

    def __init__(self, in_ch: int, num_filters, num_kernels,
                 with_bias: bool = False):
        layers = []
        for f, k in zip(num_filters, num_kernels):
            if k not in DECONV_PADDING:
                raise ValueError(f"deconv kernel {k}: 4, 3 or 2")
            pad, out_pad = DECONV_PADDING[k]
            layers += [nn.ConvTranspose2d(in_ch, f, k, 2, pad, out_pad,
                                          bias=with_bias),
                       BatchNorm2d(f), nn.ReLU(inplace=True)]
            in_ch = f
        super().__init__(*layers)


def upsample_nearest(x, factor: int):
    """Exact nearest ×factor upsample of NCHW maps (torch nn.Upsample
    mode='nearest')."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def add_upsampled(acc, y, factor: int):
    """``acc + upsample_nearest(y, factor)``: the HRNet fuse-add.  The JAX
    package's concat/blocked-view formulation is a TPU layout device; the
    math, and the order of the add, are the same."""
    if factor == 1:
        return acc + y
    return acc + upsample_nearest(y, factor)


def pixel_shuffle(x, factor: int):
    """torch ``nn.PixelShuffle``: (B, C·r², H, W) → (B, C, H·r, W·r) with
    channel-major blocks, which is the channel order of the JAX package's
    NHWC ``pixel_shuffle``."""
    return F.pixel_shuffle(x, factor)


class DUC(nn.Module):
    """Dense Upsampling Conv (decoders/DUC.py:9-28): 3×3 conv (no bias),
    BatchNorm, ReLU, then a ×``upscale`` pixel shuffle; ``planes`` is the
    width before the shuffle."""

    def __init__(self, in_ch: int, planes: int, upscale: int = 2):
        super().__init__()
        self.conv, self.bn = _conv_bn(in_ch, planes, 3, 1)
        self.upscale = upscale

    def forward(self, x):
        return pixel_shuffle(F.relu(self.bn(self.conv(x))), self.upscale)


class PixelShuffleDecoder(nn.Module):
    """Bias-free 1×1 compress to ``start_channels``, then one :class:`DUC`
    a width of ``architecture`` (decoders/pixelshuffle.py:7-31): the
    default (512, 256, 128) upsamples ×8 to 32 channels."""

    def __init__(self, in_ch: int, start_channels: int = 256,
                 architecture=(512, 256, 128)):
        super().__init__()
        self.conv_compress = nn.Conv2d(in_ch, start_channels, 1, bias=False)
        ducs, c = [], start_channels
        for planes in architecture:
            ducs.append(DUC(c, planes))
            c = planes // 4
        self.duc = nn.Sequential(*ducs)
        self.out_channels = c

    def forward(self, x):
        return self.duc(self.conv_compress(x))
