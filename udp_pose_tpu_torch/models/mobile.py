"""Mobile backbones in PyTorch, NCHW: ShuffleNetV2, ShuffleNetV2+ and
MobileNetV3-Small.

Port of ``udp_pose_tpu/models/mobile.py``.  Structure as there:

* ShuffleNetV2 (backbones/shufflenetv2.py:33-207): even/odd channel
  split, stride-2 blocks with a projection branch, ``conv_last`` 1×1;
* ShuffleNetV2+ (backbones/shufflenetv2_plus.py:34-355): hard-swish from
  the second stage, SE with a hard-sigmoid gate from the third, the
  Shuffle 3×3/5×5/7×7 and Xception blocks in the fixed order
  ``SHUFFLENETV2_PLUS_ARCH`` (:356 there);
* MobileNetV3-Small: torchvision's features (the reference wraps
  ``mobilenet_v3_small`` without its classifier,
  backbones/mobilenetv3.py:5-16), BatchNorm eps 1e-3.

Attribute names give the reference state-dict keys: ``first_conv.{0,1}``,
``features.{i}.branch_main.{j}`` / ``.branch_proj.{j}`` (with the SE's
``SE_opr.{1,2,4}``), ``conv_last.{0,1}``; MobileNetV3's
``0.{i}.block.{j}.{0,1}`` (its SE ``fc1``/``fc2``).  The activations sit
at their reference indices as parameter-free modules, so the indices of
the convs and BatchNorms match.  BatchNorm momentum 0.1 is flax's 0.9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d


def hard_sigmoid(x):
    """``clip(x + 3, 0, 6) / 6``, the JAX package's expression, which
    ``F.hardsigmoid`` computes to the bit (held in the tests)."""
    return F.hardsigmoid(x)


def hard_swish(x):
    """``x · hard_sigmoid(x)`` in that order (``F.hardswish`` rounds
    otherwise)."""
    return x * F.hardsigmoid(x)


class HardSwish(nn.Module):
    def forward(self, x):
        return hard_swish(x)


class HardSigmoid(nn.Module):
    def forward(self, x):
        return hard_sigmoid(x)


def act_module(act: str) -> nn.Module:
    """``relu`` | ``hs`` | ``none`` as a parameter-free module."""
    return {"relu": nn.ReLU, "hs": HardSwish, "none": nn.Identity}[act]()


def channel_split_even_odd(x):
    """The reference's channel shuffle (shufflenetv2.py:85-91): (even
    channels, odd channels), as strided views."""
    return x[:, 0::2], x[:, 1::2]


def conv_bn(in_ch, out_ch, kernel=1, stride=1, groups=1, eps=1e-5):
    """``[Conv2d (no bias, "same" padding), BatchNorm2d]``."""
    return [nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                      groups=groups, bias=False), BatchNorm2d(out_ch, eps)]


def conv_bn_act(in_ch, out_ch, kernel=1, stride=1, groups=1, act="relu",
                eps=1e-5) -> nn.Sequential:
    """``_ConvBNAct``: ``Sequential(conv, bn[, act])``."""
    layers = conv_bn(in_ch, out_ch, kernel, stride, groups, eps)
    if act != "none":
        layers.append(act_module(act))
    return nn.Sequential(*layers)


class _Pool(nn.Module):
    """``AdaptiveAvgPool2d(1)`` as the JAX package computes it: the mean
    over H and W."""

    def forward(self, x):
        return x.mean(dim=(2, 3), keepdim=True)


class SEHardSigmoid(nn.Module):
    """ShuffleNetV2+'s SELayer (shufflenetv2_plus.py:34-60): pooled 1×1
    conv → BN → ReLU → 1×1 conv, hard-sigmoid gate;
    ``SE_opr.{1,2,4}``."""

    def __init__(self, channels: int):
        super().__init__()
        self.SE_opr = nn.Sequential(
            _Pool(), *conv_bn(channels, channels // 4), nn.ReLU(),
            nn.Conv2d(channels // 4, channels, 1, bias=False), HardSigmoid())

    def forward(self, x):
        return x * self.SE_opr(x)


class _ShuffleBase(nn.Module):
    """The split, the main branch, the projection of a stride-2 block and
    the concatenation that ShuffleV2Block and ShuffleXception share."""

    def _proj(self, inp, ksize, act):
        return nn.Sequential(*conv_bn(inp, inp, ksize, 2, groups=inp),
                             *conv_bn(inp, inp), act_module(act))

    def forward(self, x):
        if self.stride == 1:
            x_proj, b = channel_split_even_odd(x)
        else:
            x_proj, b = x, x
        m = self.branch_main(b)
        if self.stride == 2:
            x_proj = self.branch_proj(x_proj)
        return torch.cat([x_proj, m], dim=1)


class ShuffleV2Block(_ShuffleBase):
    """shufflenetv2.py:33-91, with ``act`` / ``use_se`` for the '+'
    variant's Shufflenet block (shufflenetv2_plus.py:74-140):
    ``branch_main`` = pw(0,1) act(2) dw(3,4) pwl(5,6) act(7) [SE(8)]."""

    def __init__(self, inp: int, oup: int, mid: int, ksize: int = 3,
                 stride: int = 1, act: str = "relu", use_se: bool = False):
        super().__init__()
        self.stride = stride
        outputs = oup - inp
        main = [*conv_bn(inp, mid), act_module(act),
                *conv_bn(mid, mid, ksize, stride, groups=mid),
                *conv_bn(mid, outputs), act_module(act)]
        if use_se:
            main.append(SEHardSigmoid(outputs))
        self.branch_main = nn.Sequential(*main)
        if stride == 2:
            self.branch_proj = self._proj(inp, ksize, act)


class ShuffleXception(_ShuffleBase):
    """Shuffle_Xception (shufflenetv2_plus.py:143-219): three dw-pw pairs,
    ``branch_main`` = dw1(0,1) pw1(2,3) act(4) dw2(5,6) pw2(7,8) act(9)
    dw3(10,11) pw3(12,13) act(14) [SE(15)]."""

    def __init__(self, inp: int, oup: int, mid: int, stride: int = 1,
                 act: str = "hs", use_se: bool = False):
        super().__init__()
        self.stride = stride
        outputs = oup - inp
        main = [*conv_bn(inp, inp, 3, stride, groups=inp),
                *conv_bn(inp, mid), act_module(act),
                *conv_bn(mid, mid, 3, stride, groups=mid),
                *conv_bn(mid, mid), act_module(act),
                *conv_bn(mid, mid, 3, stride, groups=mid),
                *conv_bn(mid, outputs), act_module(act)]
        if use_se:
            main.append(SEHardSigmoid(outputs))
        self.branch_main = nn.Sequential(*main)
        if stride == 2:
            self.branch_proj = self._proj(inp, 3, act)


SHUFFLENETV2_CHANNELS = {
    "0.5x": (24, 48, 96, 192, 1024),
    "1.0x": (24, 116, 232, 464, 1024),
    "1.5x": (24, 176, 352, 704, 1024),
    "2.0x": (24, 244, 488, 976, 2048),
}


class ShuffleNetV2(nn.Module):
    """shufflenetv2.py:95-207: stride-32 features (``conv_last``'s)."""

    def __init__(self, model_size: str = "1.0x"):
        super().__init__()
        chans = SHUFFLENETV2_CHANNELS[model_size]
        self.first_conv = conv_bn_act(3, chans[0], 3, 2)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        blocks, in_ch = [], chans[0]
        for si, repeats in enumerate((4, 8, 4)):
            out_ch = chans[si + 1]
            for i in range(repeats):
                if i == 0:
                    blocks.append(ShuffleV2Block(in_ch, out_ch, out_ch // 2,
                                                 3, 2))
                else:
                    blocks.append(ShuffleV2Block(in_ch // 2, out_ch,
                                                 out_ch // 2, 3, 1))
                in_ch = out_ch
        self.features = nn.Sequential(*blocks)
        self.conv_last = conv_bn_act(in_ch, chans[4])
        self.out_channels = chans[4]

    def forward(self, x):
        x = self.maxpool(self.first_conv(x))
        return self.conv_last(self.features(x))


SHUFFLENETV2_PLUS_CHANNELS = {
    "Large": (16, 68, 168, 336, 672),
    "Medium": (16, 48, 128, 256, 512),
    "Small": (16, 36, 104, 208, 416),
}
# the fixed block types (shufflenetv2_plus.py:356): 0/1/2 the Shuffle
# 3×3/5×5/7×7 block, 3 the Xception block
SHUFFLENETV2_PLUS_ARCH = (0, 0, 3, 1, 1, 1, 0, 0, 2, 0, 2, 1, 1, 0, 2, 0, 2,
                          1, 3, 2)


class ShuffleNetV2Plus(nn.Module):
    """shufflenetv2_plus.py:233-355: 1280-channel stride-32 features."""

    def __init__(self, model_size: str = "Small"):
        super().__init__()
        chans = SHUFFLENETV2_PLUS_CHANNELS[model_size]
        self.first_conv = conv_bn_act(3, chans[0], 3, 2, act="hs")
        blocks, in_ch, ai = [], chans[0], 0
        for si, repeats in enumerate((4, 4, 8, 4)):
            out_ch = chans[si + 1]
            act = "hs" if si >= 1 else "relu"
            for i in range(repeats):
                inp = in_ch if i == 0 else in_ch // 2
                stride = 2 if i == 0 else 1
                btype = SHUFFLENETV2_PLUS_ARCH[ai]
                ai += 1
                if btype == 3:
                    blocks.append(ShuffleXception(inp, out_ch, out_ch // 2,
                                                  stride, act, si >= 2))
                else:
                    blocks.append(ShuffleV2Block(
                        inp, out_ch, out_ch // 2, (3, 5, 7)[btype], stride,
                        act, si >= 2))
                in_ch = out_ch
        self.features = nn.Sequential(*blocks)
        self.conv_last = conv_bn_act(in_ch, 1280, act="hs")
        self.out_channels = 1280

    def forward(self, x):
        return self.conv_last(self.features(self.first_conv(x)))


# torchvision mobilenet_v3_small's inverted residuals:
# (expand, out, kernel, stride, use_se, activation)
MOBILENETV3_SMALL_SPEC = (
    (16, 16, 3, 2, True, "relu"),
    (72, 24, 3, 2, False, "relu"),
    (88, 24, 3, 1, False, "relu"),
    (96, 40, 5, 2, True, "hs"),
    (240, 40, 5, 1, True, "hs"),
    (240, 40, 5, 1, True, "hs"),
    (120, 48, 5, 1, True, "hs"),
    (144, 48, 5, 1, True, "hs"),
    (288, 96, 5, 2, True, "hs"),
    (576, 96, 5, 1, True, "hs"),
    (576, 96, 5, 1, True, "hs"),
)
MNV3_BN_EPS = 1e-3


def make_divisible(v, divisor=8, min_value=None):
    """torchvision's / corenet's ``_make_divisible``."""
    min_value = divisor if min_value is None else min_value
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MNV3SqueezeExcite(nn.Module):
    """torchvision SqueezeExcitation: biased 1×1 ``fc1`` → ReLU → ``fc2``,
    hard-sigmoid gate."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x):
        a = x.mean(dim=(2, 3), keepdim=True)
        return x * hard_sigmoid(self.fc2(F.relu(self.fc1(a))))


class InvertedResidual(nn.Module):
    """torchvision's block: ``block`` = [expand] dw [SE] project, the
    residual when stride 1 keeps the width."""

    def __init__(self, in_ch, exp, out, k, s, se, act):
        super().__init__()
        layers = []
        if exp != in_ch:
            layers.append(conv_bn_act(in_ch, exp, 1, 1, act=act,
                                      eps=MNV3_BN_EPS))
        layers.append(conv_bn_act(exp, exp, k, s, groups=exp, act=act,
                                  eps=MNV3_BN_EPS))
        if se:
            layers.append(MNV3SqueezeExcite(exp, make_divisible(exp // 4)))
        layers.append(conv_bn_act(exp, out, 1, 1, act="none",
                                  eps=MNV3_BN_EPS))
        self.block = nn.Sequential(*layers)
        self.residual = s == 1 and in_ch == out

    def forward(self, x):
        y = self.block(x)
        return y + x if self.residual else y


class MobileNetV3Small(nn.Sequential):
    """torchvision ``mobilenet_v3_small().features`` (classifier
    stripped) inside the reference's one-child ``Sequential`` (keys
    ``0.{i}...``): 576 channels at stride 32."""

    def __init__(self):
        feats, in_ch = [conv_bn_act(3, 16, 3, 2, act="hs",
                                    eps=MNV3_BN_EPS)], 16
        for exp, out, k, s, se, act in MOBILENETV3_SMALL_SPEC:
            feats.append(InvertedResidual(in_ch, exp, out, k, s, se, act))
            in_ch = out
        feats.append(conv_bn_act(in_ch, 576, act="hs", eps=MNV3_BN_EPS))
        super().__init__(nn.Sequential(*feats))
        self.out_channels = 576
