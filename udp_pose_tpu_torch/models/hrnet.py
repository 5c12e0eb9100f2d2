"""PoseHRNet (HRNet-w32/w48) in PyTorch, NCHW.

Port of ``udp_pose_tpu/models/hrnet.py``.  Structure as in
deep_hrnet/lib/models/pose_hrnet.py: stem :290-297, layer1 (4×Bottleneck-64)
:297, transitions :346-386, HighResolutionModule :103-273, the last
module of stage 4 (``multi_scale_output=False``) whose branch-0 fuse
*quadruples* the channels (:198-222: j==i is a bias-free 1×1 C→4C conv with
no BN, j>i convs emit 4C), and the final 1×1 conv (×3 channels for UDP
offset) :330-340.

Attribute names give the reference state_dict keys (``conv1``, ``bn1``,
``layer1.N.*``, ``transition{t}.{i}.0/1`` or ``.{i}.{j}.0/1``,
``stage{s}.{m}.branches.{b}.{k}.*``, ``stage{s}.{m}.fuse_layers.{i}.{j}.*``,
``final_layer``), so a published ``.pth`` loads with ``strict=True``.
``psa=True`` (pose_hrnet_psa) inserts ``PSA_s`` as ``deattn`` in every
BasicBlock of the stages (pose_hrnet_psa.py:37,:49).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BasicBlock, BatchNorm2d, Bottleneck, ConvBN,
                     add_upsampled)
from .psa import PSA_s

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HRModule(nn.Module):
    """One HighResolutionModule: parallel branches + full fuse."""

    def __init__(self, num_branches: int, block: str,
                 num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int],
                 multi_scale_output: bool = True, psa: bool = False):
        super().__init__()
        block_cls = BLOCKS[block]
        attn = PSA_s if (psa and block_cls is BasicBlock) else None
        exp = block_cls.expansion
        self.num_branches = num_branches
        self.multi_scale_output = multi_scale_output
        branches = []
        for i in range(num_branches):
            blocks = []
            inplanes = in_channels[i]
            for bi in range(num_blocks[i]):
                need_down = bi == 0 and inplanes != num_channels[i] * exp
                blocks.append(block_cls(inplanes, num_channels[i], 1,
                                        downsample=need_down,
                                        attention=attn))
                inplanes = num_channels[i] * exp
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)
        ch = [c * exp for c in num_channels]

        self.fuse_layers = None
        if num_branches == 1:
            return
        n_out = num_branches if multi_scale_output else 1
        fuse = []
        for i in range(n_out):
            # last-module channel widening (pose_hrnet.py:198-202)
            out_ch = ch[i] * 4 if not multi_scale_output else ch[i]
            row = []
            for j in range(num_branches):
                if j > i:
                    # conv + BN; the nearest upsample is add_upsampled
                    row.append(ConvBN(ch[j], out_ch, 1, 1, relu=False))
                elif j == i:
                    # bias-free 1×1 C→4C, no BN (pose_hrnet.py:212-219)
                    row.append(None if multi_scale_output else nn.Sequential(
                        nn.Conv2d(ch[i], out_ch, 1, bias=False)))
                else:
                    row.append(nn.Sequential(*[
                        ConvBN(ch[j], out_ch if k == i - j - 1 else ch[j], 3,
                               2, relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        # out[i] = relu(sum_j fuse_{i,j}(x_j)), summed in j order
        # (pose_hrnet.py:258-272) for fp32 parity with the JAX package
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j > i:
                    # acc is set: the j==i (or j<i) term came first
                    acc = add_upsampled(acc, layer(outs[j]), 2 ** (j - i))
                    continue
                y = outs[j] if layer is None else layer(outs[j])
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


def stage_cfg(num_modules, num_branches, block, num_blocks, num_channels):
    """Hashable stage spec: (num_modules, num_branches, block,
    num_blocks tuple, num_channels tuple)."""
    return (int(num_modules), int(num_branches), str(block),
            tuple(num_blocks), tuple(num_channels))


class PoseHRNet(nn.Module):
    """Full HRNet pose network.  Input NCHW (B, 3, H, W); output NCHW
    (B, C_out, H/4, W/4) float32 whatever the compute dtype."""

    def __init__(self, stages_cfg: Tuple[tuple, ...], num_joints: int = 17,
                 target_type: str = "gaussian", final_conv_kernel: int = 1,
                 psa: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        #: compute dtype: models.build_model casts a serving model to it,
        #: the trainer autocasts to it over float32 weights
        self.dtype = dtype
        self.stages_cfg = tuple(stages_cfg)
        self.psa = psa
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if bi == 0 else 256, 64, 1, downsample=bi == 0)
            for bi in range(4)])

        prev_ch = [256]
        for si, scfg in enumerate(stages_cfg):
            num_modules, nb, block, num_blocks, num_channels = scfg
            width = [c * BLOCKS[block].expansion for c in num_channels]
            # transition (pose_hrnet.py:346-386): branch i<len(prev): 3x3
            # conv iff channels differ else passthrough; new branches: a
            # stride-2 chain from the last previous branch whose
            # intermediate convs keep prev_ch[-1] channels.
            trans = []
            for i in range(nb):
                if i < len(prev_ch):
                    trans.append(ConvBN(prev_ch[i], width[i], 3, 1)
                                 if prev_ch[i] != width[i] else None)
                else:
                    n = i + 1 - len(prev_ch)
                    trans.append(nn.Sequential(*[
                        ConvBN(prev_ch[-1],
                               width[i] if j == n - 1 else prev_ch[-1], 3, 2)
                        for j in range(n)]))
            setattr(self, f"transition{si + 1}", nn.ModuleList(trans))
            last_stage = si == len(stages_cfg) - 1
            setattr(self, f"stage{si + 2}", nn.ModuleList([
                HRModule(nb, block, num_blocks, width, num_channels,
                         multi_scale_output=not (last_stage
                                                 and mi == num_modules - 1),
                         psa=psa)
                for mi in range(num_modules)]))
            prev_ch = width
        self.num_stages = len(stages_cfg)

        out_ch = num_joints * 3 if target_type == "offset" else num_joints
        last = stages_cfg[-1]
        in_ch = last[4][0] * BLOCKS[last[2]].expansion * 4
        pad = 1 if final_conv_kernel == 3 else 0
        self.final_layer = nn.Conv2d(in_ch, out_ch, final_conv_kernel, 1, pad)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [x]
        for si in range(self.num_stages):
            trans = getattr(self, f"transition{si + 1}")
            new_xs = []
            for i, t in enumerate(trans):
                if i < len(xs):
                    new_xs.append(xs[i] if t is None else t(xs[i]))
                else:
                    new_xs.append(t(xs[-1]))
            xs = new_xs
            for module in getattr(self, f"stage{si + 2}"):
                xs = module(xs)
        return self.final_layer(xs[0]).float()


def stages_from_cfg(cfg):
    """The STAGE2..4 specs of ``cfg.MODEL.EXTRA`` via :func:`stage_cfg`."""
    extra = cfg.MODEL.EXTRA
    return tuple(
        stage_cfg(extra[k]["NUM_MODULES"], extra[k]["NUM_BRANCHES"],
                  extra[k]["BLOCK"], extra[k]["NUM_BLOCKS"],
                  extra[k]["NUM_CHANNELS"])
        for k in ("STAGE2", "STAGE3", "STAGE4"))


def pose_hrnet_from_cfg(cfg, psa: bool = False):
    extra = cfg.MODEL.EXTRA
    dtype = torch.bfloat16 if cfg.TPU.DTYPE == "bfloat16" else torch.float32
    return PoseHRNet(
        stages_cfg=stages_from_cfg(cfg),
        num_joints=cfg.MODEL.NUM_JOINTS,
        target_type=cfg.MODEL.TARGET_TYPE,
        final_conv_kernel=extra.FINAL_CONV_KERNEL,
        psa=psa,
        dtype=dtype,
    )
