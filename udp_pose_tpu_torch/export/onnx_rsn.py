"""ONNX emitter for the RSN family (base / SE / PRM / plain-Res18; a copy
of ``udp_pose_tpu/export/onnx_rsn.py``).

Mirrors models/rsn.RSN (reference RSN/exps/*/network.py topology) with
the reference initializer names (``utils/convert._map_rsn``) — Conv(+bias)/BN
pairs per conv_bn_relu, the dense residual-steps adds, dual skip
injection, align-corners bilinear Resize, SE (GlobalAveragePool+Gemm)
and PRM (channel × spatial gate) heads.  Output: the last stage's
full-resolution heatmap (``outputs[-1][-1]``, the inference tensor).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .onnx_build import GraphBuilder
from .onnx_pb import NodeP


def _cbr(g: GraphBuilder, x: str, tp: str, stride: int = 1,
         relu: bool = True, group: int = 1) -> str:
    x = g.conv(x, f"{tp}.conv", stride=stride, group=group)
    if f"{tp}.bn.weight" in g.sd:
        x = g.bn(x, f"{tp}.bn")
    return g.relu(x) if relu else x


def _se(g: GraphBuilder, x: str, tp: str, channels: int) -> str:
    """SELayer (prm variant network.py:51-67)."""
    s = g.global_avgpool(x)
    s = g.reshape(s, (-1, channels))
    s = g.gemm(s, f"{tp}.fc.0")
    s = g.relu(s)
    s = g.gemm(s, f"{tp}.fc.2")
    s = g.sigmoid(s)
    s = g.reshape(s, (-1, channels, 1, 1))
    return g.mul(x, s)


def _rsn_bottleneck(g: GraphBuilder, x: str, tp: str, stride: int,
                    plain: bool, se: bool) -> str:
    """Residual-steps bottleneck (network.py:49-122)."""
    if plain:
        out = _cbr(g, x, f"{tp}.conv_bn_relu1", stride=stride)
        out = _cbr(g, out, f"{tp}.conv_bn_relu2")
        out = _cbr(g, out, f"{tp}.conv_bn_relu3", relu=False)
    else:
        out = _cbr(g, x, f"{tp}.conv_bn_relu1", stride=stride)
        bc = int(g.sd[f"{tp}.conv_bn_relu1.conv.weight"].shape[0]) // 4
        spx = g.split(out, [bc] * 4, axis=1)

        def step(name, v):
            return _cbr(g, v, f"{tp}.{name}")

        o11 = step("conv_bn_relu2_1_1", spx[0])
        o21 = step("conv_bn_relu2_2_1", g.add(spx[1], o11))
        o22 = step("conv_bn_relu2_2_2", o21)
        o31 = step("conv_bn_relu2_3_1", g.add(spx[2], o21))
        o32 = step("conv_bn_relu2_3_2", g.add(o31, o22))
        o33 = step("conv_bn_relu2_3_3", o32)
        o41 = step("conv_bn_relu2_4_1", g.add(spx[3], o31))
        o42 = step("conv_bn_relu2_4_2", g.add(o41, o32))
        o43 = step("conv_bn_relu2_4_3", g.add(o42, o33))
        o44 = step("conv_bn_relu2_4_4", o43)
        out = g.concat([o11, o22, o33, o44], axis=1)
        out = _cbr(g, out, f"{tp}.conv_bn_relu3", relu=False)
    if se and f"{tp}.se.fc.0.weight" in g.sd:
        channels = int(g.sd[f"{tp}.conv_bn_relu3.conv.weight"].shape[0])
        out = _se(g, out, f"{tp}.se", channels)
    res = x
    if f"{tp}.downsample.conv.weight" in g.sd:
        res = _cbr(g, x, f"{tp}.downsample", stride=stride, relu=False)
    return g.relu(g.add(out, res))


def _prm(g: GraphBuilder, x: str, tp: str, channels: int) -> str:
    """Pose Refine Machine (prm variant network.py:267-302)."""
    out1 = _cbr(g, x, f"{tp}.conv_bn_relu_prm_1")
    g2 = g.global_avgpool(out1)
    g2 = _cbr(g, g2, f"{tp}.conv_bn_relu_prm_2_1")
    g2 = _cbr(g, g2, f"{tp}.conv_bn_relu_prm_2_2")
    g2 = g.sigmoid(g2)
    g3 = _cbr(g, out1, f"{tp}.conv_bn_relu_prm_3_1")
    g3 = _cbr(g, g3, f"{tp}.conv_bn_relu_prm_3_2", group=channels)
    g3 = g.sigmoid(g3)
    gate = g.mul(g2, g3)
    one = g.const("const_one", np.ones((1,), np.float32))
    gate = g.add(gate, one)
    return g.mul(out1, gate)


def build_rsn(sd: Dict[str, np.ndarray], cfg, batch: int = 1) -> bytes:
    extra = cfg.MODEL.EXTRA
    stage_num = extra.get("STAGE_NUM", 1)
    layers = tuple(extra.get("LAYERS", (2, 2, 2, 2)))
    plain = extra.get("PLAIN_BOTTLENECK", False)
    se = extra.get("USE_SE", False)
    use_prm = extra.get("USE_PRM", False)
    num_joints = cfg.MODEL.NUM_JOINTS
    w_img, h_img = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    w_out, h_out = (int(v) for v in cfg.MODEL.HEATMAP_SIZE)

    g = GraphBuilder(sd, "rsn")
    if "top.conv.0.conv.weight" in sd:
        # SE/PRM experiment 3-conv stem (its network.py:188-202)
        x = _cbr(g, "images", "top.conv.0", stride=2)
        x = _cbr(g, x, "top.conv.1")
        x = _cbr(g, x, "top.conv.2", stride=2)
    else:
        x = _cbr(g, "images", "top.conv", stride=2)
        x = g.maxpool(x)

    skip1: Optional[list] = None
    skip2: Optional[list] = None
    final = None
    for si in range(stage_num):
        last = si == stage_num - 1
        # downsample module (network.py:140-199)
        feats = []
        td = f"stage{si}.downsample"
        for li, blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            for bi in range(blocks):
                x = _rsn_bottleneck(g, x, f"{td}.layer{li + 1}.{bi}",
                                    stride if bi == 0 else 1, plain, se)
            if skip1 is not None:
                x = g.add(g.add(x, skip1[li]), skip2[li])
            feats.append(x)
        x1, x2, x3, x4 = feats
        # upsample module (network.py:270-310); units see small → large
        xs = [x4, x3, x2, x1]
        tu = f"stage{si}.upsample"
        up_x = None
        new_s1, new_s2, cross = [], [], None
        for ui in range(4):
            tup = f"{tu}.up{ui + 1}"
            out = _cbr(g, xs[ui], f"{tup}.u_skip", relu=False)
            if ui > 0:
                up = g.upsample(up_x, 2, mode="linear", align_corners=True)
                up = _cbr(g, up, f"{tup}.up_conv", relu=False)
                out = g.add(out, up)
            out = g.relu(out)
            if use_prm and ui == 3 and \
                    f"{tup}.prm.conv_bn_relu_prm_1.conv.weight" in sd:
                chl = int(sd[f"{tup}.u_skip.conv.weight"].shape[0])
                out = _prm(g, out, f"{tup}.prm", chl)
            res = _cbr(g, out, f"{tup}.res_conv1")
            res = _cbr(g, res, f"{tup}.res_conv2", relu=False)
            factor = 2 ** (3 - ui)
            if factor > 1:
                res = g.upsample(res, factor, mode="linear",
                                 align_corners=True)
            if last and ui == 3:
                final = res
            if not last:
                new_s1.append(_cbr(g, xs[ui], f"{tup}.skip1"))
                new_s2.append(_cbr(g, out, f"{tup}.skip2"))
                if ui == 3:
                    cross = _cbr(g, out, f"{tup}.cross_conv")
            up_x = out
        skip1 = new_s1[::-1] if new_s1 else None
        skip2 = new_s2[::-1] if new_s2 else None
        x = cross

    g.nodes.append(  # name the inference tensor
        NodeP("Identity", [final], ["output"], name="out_id"))
    return g.finish("images", (batch, 3, h_img, w_img), "output",
                    (batch, num_joints, h_out, w_out),
                    doc=f"rsn stages={stage_num} {w_img}x{h_img}")
