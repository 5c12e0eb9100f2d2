"""Residual Steps Network (RSN / MSPN family) in PyTorch, NCHW.

Port of ``udp_pose_tpu/models/rsn.py`` (structure: RSN/exps/RSN18.coco/
network.py — conv_bn_relu :14-46, the residual-steps Bottleneck :49-122,
ResNet_top :125-137, ResNet_downsample_module :140-199, Upsample_unit
:202-267, Upsample_module :270-310, Single_stage_module :313-334, RSN
:337-412; the SE layer and the PRM head of the SE/PRM experiment's
network.py :51-67, :267-302).

Attribute names give the reference state_dict keys that the JAX
package's ``_map_rsn`` walks (``top.conv``, ``stage{i}.downsample.
layer{l}.{b}.conv_bn_relu{1,3}`` / ``.conv_bn_relu2_{i}_{j}``,
``stage{i}.upsample.up{u}.{u_skip,up_conv,res_conv1,res_conv2,skip1,
skip2,cross_conv}``), so a published ``.pth`` loads with ``strict=True``.

``F.interpolate(mode='bilinear', align_corners=True)`` is computed as
the JAX package computes it, as two interpolation matrices applied in
float32 (:func:`resize_bilinear_ac`), so that float32 outputs agree.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.blur import _ieee_fp32_matmul
from .layers import BatchNorm2d, max_pool_3x3_s2


@lru_cache(maxsize=None)
def interp_matrix_ac(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners bilinear interpolation matrix."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        A[:, 0] = 1.0
        return A
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        A[i, lo] += 1.0 - f
        A[i, hi] += f
    A.setflags(write=False)
    return A


@lru_cache(maxsize=None)
def _interp_tensor(n_in: int, n_out: int, device: torch.device):
    """The matrix on ``device``, kept once made; made outside inference
    mode, so that a train step may use what a serving call cached."""
    with torch.inference_mode(False):
        return torch.from_numpy(interp_matrix_ac(n_in, n_out).copy()).to(
            device)


def resize_bilinear_ac(x, out_hw):
    """NCHW align-corners bilinear resize of ``x`` to ``out_hw``
    (torch ``F.interpolate(..., align_corners=True)``): ``A_h · x · A_wᵀ``
    in float32 (float64 for a float64 ``x``), cast back to ``x``'s
    dtype."""
    H, W = x.shape[-2:]
    oh, ow = out_hw
    if (H, W) == (oh, ow):
        return x
    dtype = torch.promote_types(x.dtype, torch.float32)
    Ah = _interp_tensor(H, oh, x.device).to(dtype)
    Aw = _interp_tensor(W, ow, x.device).to(dtype)
    with _ieee_fp32_matmul(), torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("oh,bchw,pw->bcop", Ah, x.to(dtype), Aw)
    return y.to(x.dtype)


class ConvBnRelu(nn.Module):
    """conv_bn_relu (network.py:14-46): a conv *with bias*, BatchNorm
    (momentum 0.9 in flax's convention, eps 1e-5) and an optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, groups: int = 1):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad,
                              groups=groups, bias=True)
        self.bn = BatchNorm2d(out_ch)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class SELayer(nn.Module):
    """Squeeze-excitation (SE/PRM experiment network.py:51-67):
    ``fc.0`` / ``fc.2`` bias-free linears."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(inplace=True),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x):
        s = self.fc(x.mean(dim=(2, 3)))
        return x * s[:, :, None, None]


_STEPS = ("2_1_1", "2_2_1", "2_2_2", "2_3_1", "2_3_2", "2_3_3", "2_4_1",
          "2_4_2", "2_4_3", "2_4_4")


class RSNBottleneck(nn.Module):
    """The residual-steps bottleneck (network.py:49-122): a 1×1 expand to
    4·bc channels (bc = in_planes·26//64, or planes·26//64 with
    ``bc_planes``), split four ways, densely connected 3×3 steps (branch
    i runs i convs, each fed by the previous step of its branch plus the
    matching step of the branch before), concat, 1×1 project.
    ``plain``: the Res18 ablation's 1-3-1 block, which strides its 3×3
    (Res18.coco/network.py:55-69)."""
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, plain: bool = False,
                 se: bool = False, bc_planes: bool = False):
        super().__init__()
        self.plain = plain
        if plain:
            self.conv_bn_relu1 = ConvBnRelu(in_planes, planes, 1, 1)
            self.conv_bn_relu2 = ConvBnRelu(planes, planes, 3, stride)
            self.conv_bn_relu3 = ConvBnRelu(planes, planes, 1, 1,
                                            relu=False)
        else:
            bc = (planes if bc_planes else in_planes) * 26 // 64
            self.bc = bc
            self.conv_bn_relu1 = ConvBnRelu(in_planes, 4 * bc, 1, stride)
            for s in _STEPS:
                setattr(self, f"conv_bn_relu{s}", ConvBnRelu(bc, bc, 3, 1))
            self.conv_bn_relu3 = ConvBnRelu(4 * bc, planes, 1, 1,
                                            relu=False)
        # reduction 8 in the SE/PRM experiment (its network.py:113)
        self.se = SELayer(planes, reduction=8) if se else None
        self.downsample = (ConvBnRelu(in_planes, planes, 1, stride,
                                      relu=False) if downsample else None)

    def forward(self, x):
        if self.plain:
            out = self.conv_bn_relu3(self.conv_bn_relu2(
                self.conv_bn_relu1(x)))
        else:
            out = self.conv_bn_relu1(x)
            bc = self.bc
            spx = [out[:, i * bc:(i + 1) * bc] for i in range(4)]

            def step(name, v):
                return getattr(self, f"conv_bn_relu{name}")(v)

            o11 = step("2_1_1", spx[0])
            o21 = step("2_2_1", spx[1] + o11)
            o22 = step("2_2_2", o21)
            o31 = step("2_3_1", spx[2] + o21)
            o32 = step("2_3_2", o31 + o22)
            o33 = step("2_3_3", o32)
            o41 = step("2_4_1", spx[3] + o31)
            o42 = step("2_4_2", o41 + o32)
            o43 = step("2_4_3", o42 + o33)
            o44 = step("2_4_4", o43)
            out = self.conv_bn_relu3(torch.cat([o11, o22, o33, o44], dim=1))
        if self.se is not None:
            out = self.se(out)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def remat_call(block, x):
    """``block(x)`` whose activations the backward recomputes instead of
    keeping (``torch.utils.checkpoint``, non-reentrant; the JAX package's
    ``nn.checkpoint``).  The recomputed forward leaves the block's
    BatchNorm running stats as the first forward left them."""
    calls = [0]

    def forward(v):
        calls[0] += 1
        if calls[0] == 1:
            return block(v)
        bns = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
        for m in bns:
            m.update_stats = False
        try:
            return block(v)
        finally:
            for m in bns:
                m.update_stats = True

    return checkpoint(forward, x, use_reentrant=False)


class DownsampleModule(nn.Module):
    """ResNet_downsample_module (network.py:140-199): four layers of
    bottlenecks (64, 128, 256, 512 planes; strides 1, 2, 2, 2), each
    layer's output plus the previous stage's two skips when
    ``has_skip``; returns the features deepest first.  ``remat``
    (``TPU.REMAT``): each bottleneck's activations are recomputed in the
    backward (:func:`remat_call`; the reference's efficient/checkpoint
    flag, ``udp_pose_tpu/models/rsn.py:178-190``)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 has_skip: bool = False, plain: bool = False,
                 se: bool = False, bc_planes: bool = False,
                 remat: bool = False):
        super().__init__()
        self.has_skip = has_skip
        self.remat = remat
        in_planes = 64
        for li, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            seq = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                need_down = bi == 0 and (s != 1 or in_planes != planes)
                seq.append(RSNBottleneck(in_planes, planes, s, need_down,
                                         plain, se, bc_planes))
                in_planes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*seq))

    def forward(self, x, skip1=None, skip2=None):
        feats = []
        remat = self.remat and torch.is_grad_enabled()
        for li in range(4):
            for block in getattr(self, f"layer{li + 1}"):
                x = remat_call(block, x) if remat else block(x)
            if self.has_skip:
                x = x + skip1[li] + skip2[li]
            feats.append(x)
        return feats[::-1]


class PRM(nn.Module):
    """Pose Refine Machine (SE/PRM experiment network.py:267-302):
    ``out₁ · (1 + channel_gate · spatial_gate)``; its 9×9 spatial gate
    is depthwise (``groups = C``)."""

    def __init__(self, channels: int):
        super().__init__()
        C = channels
        self.conv_bn_relu_prm_1 = ConvBnRelu(C, C, 3, 1)
        self.conv_bn_relu_prm_2_1 = ConvBnRelu(C, C, 1, 1)
        self.conv_bn_relu_prm_2_2 = ConvBnRelu(C, C, 1, 1)
        self.conv_bn_relu_prm_3_1 = ConvBnRelu(C, C, 1, 1)
        self.conv_bn_relu_prm_3_2 = ConvBnRelu(C, C, 9, 1, groups=C)

    def forward(self, x):
        out1 = self.conv_bn_relu_prm_1(x)
        g2 = out1.mean(dim=(2, 3), keepdim=True)
        g2 = torch.sigmoid(self.conv_bn_relu_prm_2_2(
            self.conv_bn_relu_prm_2_1(g2)))
        g3 = torch.sigmoid(self.conv_bn_relu_prm_3_2(
            self.conv_bn_relu_prm_3_1(out1)))
        return out1 * (1.0 + g2 * g3)


class UpsampleUnit(nn.Module):
    """Upsample_unit (network.py:202-267): the lateral 1×1 (``u_skip``)
    plus the resized coarser unit's output through ``up_conv``, ReLU,
    [PRM on the last unit], the two res convs to ``output_chl_num``
    heatmaps resized to ``output_shape``; with ``gen_skip`` the skips to
    the next stage, with ``gen_cross_conv`` on the last unit its input."""

    def __init__(self, ind: int, in_ch: int, up_size: Tuple[int, int],
                 output_chl_num: int, output_shape: Tuple[int, int],
                 chl_num: int = 256, gen_skip: bool = False,
                 gen_cross_conv: bool = False, use_prm: bool = False):
        super().__init__()
        self.ind, self.up_size, self.output_shape = ind, up_size, output_shape
        self.u_skip = ConvBnRelu(in_ch, chl_num, 1, 1, relu=False)
        if ind > 0:
            self.up_conv = ConvBnRelu(chl_num, chl_num, 1, 1, relu=False)
        self.prm = PRM(chl_num) if (use_prm and ind == 3) else None
        self.res_conv1 = ConvBnRelu(chl_num, chl_num, 1, 1)
        self.res_conv2 = ConvBnRelu(chl_num, output_chl_num, 3, 1,
                                    relu=False)
        if gen_skip:
            self.skip1 = ConvBnRelu(in_ch, in_ch, 1, 1)
            self.skip2 = ConvBnRelu(chl_num, in_ch, 1, 1)
        self.gen_skip = gen_skip
        self.cross_conv = (ConvBnRelu(chl_num, 64, 1, 1)
                           if (ind == 3 and gen_cross_conv) else None)

    def forward(self, x, up_x):
        out = self.u_skip(x)
        if self.ind > 0:
            out = out + self.up_conv(resize_bilinear_ac(up_x, self.up_size))
        out = F.relu(out)
        if self.prm is not None:
            out = self.prm(out)
        res = self.res_conv2(self.res_conv1(out))
        res = resize_bilinear_ac(res, self.output_shape)
        skip1 = skip2 = None
        if self.gen_skip:
            skip1 = self.skip1(x)
            skip2 = self.skip2(out)
        cross = None if self.cross_conv is None else self.cross_conv(out)
        return out, res, skip1, skip2, cross


class UpsampleModule(nn.Module):
    """Upsample_module (network.py:270-310): four units from the deepest
    feature to the finest; returns the four heatmaps (coarse unit first),
    the two skip pyramids (finest first) and the cross feature."""

    def __init__(self, output_chl_num: int, output_shape: Tuple[int, int],
                 chl_num: int = 256, gen_skip: bool = False,
                 gen_cross_conv: bool = False, use_prm: bool = False):
        super().__init__()
        h, w = output_shape
        sizes = [(h // 8, w // 8), (h // 4, w // 4), (h // 2, w // 2),
                 (h, w)]
        for i, in_ch in enumerate((512, 256, 128, 64)):
            setattr(self, f"up{i + 1}", UpsampleUnit(
                i, in_ch, sizes[i], output_chl_num, output_shape, chl_num,
                gen_skip, gen_cross_conv, use_prm))

    def forward(self, x4, x3, x2, x1):
        res, skip1, skip2 = [], [], []
        up_x = cross = None
        for i, x in enumerate((x4, x3, x2, x1)):
            up_x, r, s1, s2, cc = getattr(self, f"up{i + 1}")(x, up_x)
            res.append(r)
            skip1.append(s1)
            skip2.append(s2)
            if cc is not None:
                cross = cc
        return res, skip1[::-1], skip2[::-1], cross


class SingleStage(nn.Module):
    """Single_stage_module (network.py:313-334): ``downsample`` then
    ``upsample``."""

    def __init__(self, output_chl_num, output_shape, chl_num, layers,
                 has_skip, gen_skip, gen_cross_conv, plain, se, bc_planes,
                 use_prm, remat=False):
        super().__init__()
        self.downsample = DownsampleModule(layers, has_skip, plain, se,
                                           bc_planes, remat)
        self.upsample = UpsampleModule(output_chl_num, output_shape, chl_num,
                                       gen_skip, gen_cross_conv, use_prm)

    def forward(self, x, skip1, skip2):
        return self.upsample(*self.downsample(x, skip1, skip2))


class RSNTop(nn.Module):
    """ResNet_top (network.py:125-137): the 7×7/2 conv and the 3×3/2 max
    pool, or with ``conv_stem`` the SE/PRM experiment's three convs and
    no pool (its network.py:188-202)."""

    def __init__(self, conv_stem: bool = False):
        super().__init__()
        self.conv_stem = conv_stem
        if conv_stem:
            self.conv = nn.Sequential(ConvBnRelu(3, 64, 3, 2),
                                      ConvBnRelu(64, 64, 7, 1),
                                      ConvBnRelu(64, 64, 3, 2))
        else:
            self.conv = ConvBnRelu(3, 64, 7, 2)
            self.maxpool = max_pool_3x3_s2()

    def forward(self, x):
        x = self.conv(x)
        return x if self.conv_stem else self.maxpool(x)


class RSN(nn.Module):
    """Multi-stage RSN (network.py:337-412).  Input NCHW (B, 3, H, W).
    In train mode, or with ``all_stages``, the list of stages, each the
    list of its four (B, J, h, w) heatmaps (coarse unit first) in the
    compute dtype; else the last stage's finest heatmap, float32."""

    def __init__(self, stage_num: int = 1, output_chl_num: int = 17,
                 output_shape: Tuple[int, int] = (64, 48),
                 upsample_chl_num: int = 256,
                 layers: Sequence[int] = (2, 2, 2, 2), plain: bool = False,
                 se: bool = False, bc_planes: bool = False,
                 conv_stem: bool = False, use_prm: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        #: compute dtype, as ``PoseHRNet.dtype``
        self.dtype = dtype
        # the family arguments of the weight and conv-site maps
        self.stage_num, self.layers = stage_num, tuple(layers)
        self.plain, self.se, self.use_prm = plain, se, use_prm
        self.top = RSNTop(conv_stem)
        for i in range(stage_num):
            last = i == stage_num - 1
            setattr(self, f"stage{i}", SingleStage(
                output_chl_num, output_shape, upsample_chl_num,
                tuple(layers), i > 0, not last, not last, plain, se,
                bc_planes, use_prm, remat))

    def forward(self, x, all_stages: bool = False):
        x = self.top(x)
        skip1 = skip2 = None
        outputs = []
        for i in range(self.stage_num):
            res, skip1, skip2, x = getattr(self, f"stage{i}")(x, skip1,
                                                              skip2)
            outputs.append(res)
        if all_stages or self.training:
            return outputs
        return outputs[-1][-1].float()


def rsn_from_cfg(cfg):
    extra = cfg.MODEL.EXTRA
    dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
    w, h = cfg.MODEL.HEATMAP_SIZE
    se = extra.get("USE_SE", False)
    return RSN(
        stage_num=extra.get("STAGE_NUM", 1),
        output_chl_num=cfg.MODEL.NUM_JOINTS,
        output_shape=(h, w),
        upsample_chl_num=extra.get("UPSAMPLE_CHANNEL_NUM", 256),
        layers=tuple(extra.get("LAYERS", (2, 2, 2, 2))),
        plain=extra.get("PLAIN_BOTTLENECK", False),
        se=se,
        # the reference SE/PRM experiment couples these with USE_SE
        bc_planes=extra.get("BC_FROM_PLANES", se),
        conv_stem=extra.get("CONV_STEM", se),
        use_prm=extra.get("USE_PRM", False),
        remat=cfg.TPU.REMAT,
        dtype=dtype,
    )
