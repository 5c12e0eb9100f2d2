"""YOLOv5 (v6.0 architecture) person detector in PyTorch, NCHW.

Port of ``udp_pose_tpu/models/yolov5.py``: CSP backbone (6×6 stem, C3
blocks, SPPF), PANet head with nearest ×2 upsampling, and the detect
head with its anchor decode to the raw ``(B, N, 5 + nc)`` prediction
that :func:`..ops.yolo.non_max_suppression` reads (xywh in input pixels,
sigmoided objectness and class scores).  Rows run over (y, x, anchor)
of each level, P3 then P4 then P5, as in the JAX package.

Module names follow the ultralytics v6.0 state dict (``model.{i}.conv``,
``.bn``, ``.cv1``–``cv3``, ``.m.{j}``, the detect convs ``model.24.m.{l}``),
so an ultralytics ``yolov5*.pt`` state dict loads with ``strict=True``
once its ``anchor*`` buffers are dropped (:mod:`..utils.convert`).  The
network computes in float32, as the JAX detector does; the anchor decode
runs in float32 whatever the input.

Variants: n (depth 0.33, width 0.25), s (0.33, 0.50), m (0.67, 0.75),
l (1.0, 1.0).
"""

from __future__ import annotations

import math

import torch
from torch import nn

ANCHORS = (  # per level (P3/8, P4/16, P5/32), (w, h) pixel units
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
VARIANTS = {"n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
            "l": (1.0, 1.0)}
# flax BatchNorm(momentum=0.97, epsilon=1e-3) in torch's convention
BN_EPS, BN_MOMENTUM = 1e-3, 0.03


def _make_divisible(x, divisor=8):
    return int(math.ceil(x / divisor) * divisor)


class ConvBnSiLU(nn.Module):
    """Conv (no bias, 'same' padding) → BatchNorm → SiLU."""

    def __init__(self, c_in, c_out, kernel=1, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel, stride, (kernel - 1) // 2,
                              bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU(inplace=True)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True):
        super().__init__()
        self.cv1 = ConvBnSiLU(c_in, c_out, 1)
        self.cv2 = ConvBnSiLU(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return y + x if self.add else y


class C3(nn.Module):
    def __init__(self, c_in, c_out, n=1, shortcut=True):
        super().__init__()
        c_ = c_out // 2
        self.cv1 = ConvBnSiLU(c_in, c_, 1)
        self.cv2 = ConvBnSiLU(c_in, c_, 1)
        self.cv3 = ConvBnSiLU(2 * c_, c_out, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """cv1, three chained 5×5 stride-1 max pools, cv2 over the concat."""

    def __init__(self, c_in, c_out, pool=5):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBnSiLU(c_in, c_, 1)
        self.cv2 = ConvBnSiLU(c_ * 4, c_out, 1)
        self.m = nn.MaxPool2d(pool, 1, pool // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1))


class Detect(nn.Module):
    """The three 1×1 head convs (with bias) and the anchor decode."""

    def __init__(self, num_classes, channels):
        super().__init__()
        self.no = 5 + num_classes
        self.m = nn.ModuleList(nn.Conv2d(c, len(a) * self.no, 1)
                               for c, a in zip(channels, ANCHORS))
        # on the module's device, out of the state dict (ultralytics keeps
        # its own anchor buffers, which the loaders drop)
        self.register_buffer("anchor_wh", torch.tensor(
            ANCHORS, dtype=torch.float32), persistent=False)

    def forward(self, feats):
        preds = []
        for li, (conv, feat) in enumerate(zip(self.m, feats)):
            t = conv(feat)
            B, _, H, W = t.shape
            na = len(ANCHORS[li])
            # (B, na·no, H, W) → (B, H, W, na, no): the JAX package's order
            t = t.float().view(B, na, self.no, H, W).permute(0, 3, 4, 1, 2)
            t = torch.sigmoid(t)
            gy, gx = torch.meshgrid(
                torch.arange(H, dtype=torch.float32, device=t.device),
                torch.arange(W, dtype=torch.float32, device=t.device),
                indexing="ij")
            grid = torch.stack([gx, gy], -1)[:, :, None, :]   # (H, W, 1, 2)
            xy = (t[..., 0:2] * 2.0 - 0.5 + grid) * float(STRIDES[li])
            wh = (t[..., 2:4] * 2.0) ** 2 * self.anchor_wh[li].float()
            pred = torch.cat([xy, wh, t[..., 4:]], -1)
            preds.append(pred.reshape(B, H * W * na, self.no))
        return torch.cat(preds, 1)


class Concat(nn.Module):
    """Placeholder for the ultralytics concat layers (no weights); the
    forward concatenates explicitly."""


class YOLOv5(nn.Module):
    """``forward(x)``: (B, 3, H, W) float in [0, 1], H and W multiples of
    32 → (B, N, 5 + nc) raw predictions in float32."""

    def __init__(self, variant="n", num_classes=80):
        super().__init__()
        if variant not in VARIANTS:
            raise KeyError(f"unknown YOLOv5 variant {variant!r}; "
                           f"available: {sorted(VARIANTS)}")
        d, w = VARIANTS[variant]
        ch = lambda c: _make_divisible(c * w)            # noqa: E731
        dn = lambda n: max(round(n * d), 1)              # noqa: E731
        self.variant = variant
        self.num_classes = num_classes
        #: compute dtype: the detector runs in float32 (the JAX default)
        self.dtype = torch.float32
        up = nn.Upsample(scale_factor=2, mode="nearest")
        self.model = nn.ModuleList([
            ConvBnSiLU(3, ch(64), 6, 2),                       # 0
            ConvBnSiLU(ch(64), ch(128), 3, 2),                 # 1
            C3(ch(128), ch(128), dn(3)),                       # 2
            ConvBnSiLU(ch(128), ch(256), 3, 2),                # 3
            C3(ch(256), ch(256), dn(6)),                       # 4  P3
            ConvBnSiLU(ch(256), ch(512), 3, 2),                # 5
            C3(ch(512), ch(512), dn(9)),                       # 6  P4
            ConvBnSiLU(ch(512), ch(1024), 3, 2),               # 7
            C3(ch(1024), ch(1024), dn(3)),                     # 8
            SPPF(ch(1024), ch(1024), 5),                       # 9  P5
            ConvBnSiLU(ch(1024), ch(512), 1),                  # 10
            up, Concat(),                                      # 11, 12
            C3(ch(1024), ch(512), dn(3), False),               # 13
            ConvBnSiLU(ch(512), ch(256), 1),                   # 14
            up, Concat(),                                      # 15, 16
            C3(ch(512), ch(256), dn(3), False),                # 17 out3
            ConvBnSiLU(ch(256), ch(256), 3, 2),                # 18
            Concat(),                                          # 19
            C3(ch(512), ch(512), dn(3), False),                # 20 out4
            ConvBnSiLU(ch(512), ch(512), 3, 2),                # 21
            Concat(),                                          # 22
            C3(ch(1024), ch(1024), dn(3), False),              # 23 out5
            Detect(num_classes, (ch(256), ch(512), ch(1024))),  # 24
        ])

    def forward(self, x):
        m = self.model
        x = m[1](m[0](x))
        p3 = m[4](m[3](m[2](x)))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        h10 = m[10](p5)
        h14 = m[14](m[13](torch.cat([m[11](h10), p4], 1)))
        out3 = m[17](torch.cat([m[15](h14), p3], 1))
        out4 = m[20](torch.cat([m[18](out3), h14], 1))
        out5 = m[23](torch.cat([m[21](out4), h10], 1))
        return m[24]((out3, out4, out5))
