"""ONNX emitters for the mobile pose zoo (opset 11; a copy of
``udp_pose_tpu/export/onnx_mobile.py``).

Consumes reference-format torch state dicts (the port's models' own) and
replays the reference architectures in NCHW:

* ShuffleNetV2 / ShuffleNetV2+ (backbones/shufflenetv2.py:33-207,
  shufflenetv2_plus.py:34-355) — strided channel Slice for the even/odd
  split, HardSigmoid SE gates, hard-swish as x·HardSigmoid(x).
* MobileNetV3-Small (torchvision layout, backbones/mobilenetv3.py:5-16).
* MobileViT / MobileViTv2 (backbones/mobilevit.py:517-679,
  mobilevitv2.py:547-1040) — patch unfold/fold as Reshape/Transpose,
  decomposed LayerNorm, MatMul attention (v1) / separable linear
  attention with ReduceSum context (v2).
* Heads: SimpleBaseline deconv chain or PixelShuffle decoder
  (decoders/pixelshuffle.py — DepthToSpace mode=CRD == torch
  nn.PixelShuffle).

MobileViT emitters require patch-divisible stage sizes (image H, W
divisible by 64); the models also handle the resize path, which is
out of the fixed-shape export contract.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .onnx_build import GraphBuilder
from .onnx_families import deconv_head as _deconv_head

# ---------------------------------------------------------------- helpers


def _hsig(g: GraphBuilder, x: str) -> str:
    """torch Hardsigmoid == relu6(x+3)/6 == HardSigmoid(1/6, 0.5)."""
    return g.node("HardSigmoid", [x], alpha=1.0 / 6.0, beta=0.5)


def _hswish(g: GraphBuilder, x: str) -> str:
    return g.mul(x, _hsig(g, x))


def _silu(g: GraphBuilder, x: str) -> str:
    return g.mul(x, g.sigmoid(x))


def _act(g: GraphBuilder, x: str, act: str) -> str:
    if act == "relu":
        return g.relu(x)
    if act == "hs":
        return _hswish(g, x)
    return x


# ------------------------------------------------------------ shufflenets


def _se_hs(g: GraphBuilder, x: str, tp: str) -> str:
    """ShuffleNetV2+ SELayer (shufflenetv2_plus.py:34-60)."""
    a = g.global_avgpool(x)
    a = g.conv(a, f"{tp}.SE_opr.1", pad=0)
    a = g.relu(g.bn(a, f"{tp}.SE_opr.2"))
    a = g.conv(a, f"{tp}.SE_opr.4", pad=0)
    return g.mul(x, _hsig(g, a))


def _split_even_odd(g: GraphBuilder, x: str, channels: int):
    return (g.slice_axis(x, 0, channels, axis=1, step=2),
            g.slice_axis(x, 1, channels, axis=1, step=2))


def _shuffle_block(g: GraphBuilder, x: str, tp: str, inp: int, oup: int,
                   mid: int, ksize: int, stride: int, act: str,
                   use_se: bool, cur_ch: int) -> str:
    """ShuffleV2Block (shufflenetv2.py:33-91 / Shufflenet '+' variant)."""
    if stride == 1:
        x_proj, b = _split_even_odd(g, x, cur_ch)
    else:
        x_proj, b = x, x
    m = _act(g, g.bn(g.conv(b, f"{tp}.branch_main.0", pad=0),
                     f"{tp}.branch_main.1"), act)
    m = g.bn(g.conv(m, f"{tp}.branch_main.3", stride=stride, group=mid),
             f"{tp}.branch_main.4")
    m = _act(g, g.bn(g.conv(m, f"{tp}.branch_main.5", pad=0),
                     f"{tp}.branch_main.6"), act)
    if use_se:
        m = _se_hs(g, m, f"{tp}.branch_main.8")
    if stride == 2:
        p = g.bn(g.conv(x_proj, f"{tp}.branch_proj.0", stride=2, group=inp),
                 f"{tp}.branch_proj.1")
        x_proj = _act(g, g.bn(g.conv(p, f"{tp}.branch_proj.2", pad=0),
                              f"{tp}.branch_proj.3"), act)
    return g.concat([x_proj, m])


def _xception_block(g: GraphBuilder, x: str, tp: str, inp: int, oup: int,
                    mid: int, stride: int, act: str, use_se: bool,
                    cur_ch: int) -> str:
    """Shuffle_Xception (shufflenetv2_plus.py:143-219): dw-pw ×3 chain."""
    if stride == 1:
        x_proj, b = _split_even_odd(g, x, cur_ch)
    else:
        x_proj, b = x, x
    m = b
    chain = [("0", inp, stride, None), ("2", None, 1, act),
             ("5", mid, stride, None), ("7", None, 1, act),
             ("10", mid, stride, None), ("12", None, 1, act)]
    for ti, grp, s, a in chain:
        m = g.bn(g.conv(m, f"{tp}.branch_main.{ti}",
                        stride=s, group=grp or 1,
                        pad=None if grp else 0),
                 f"{tp}.branch_main.{int(ti) + 1}")
        if a:
            m = _act(g, m, a)
    if use_se:
        m = _se_hs(g, m, f"{tp}.branch_main.15")
    if stride == 2:
        p = g.bn(g.conv(x_proj, f"{tp}.branch_proj.0", stride=2, group=inp),
                 f"{tp}.branch_proj.1")
        x_proj = _act(g, g.bn(g.conv(p, f"{tp}.branch_proj.2", pad=0),
                              f"{tp}.branch_proj.3"), act)
    return g.concat([x_proj, m])


def _emit_shufflenetv2(g: GraphBuilder, x: str, p: str,
                       model_size: str = "1.0x") -> str:
    from ..models.mobile import SHUFFLENETV2_CHANNELS
    chans = SHUFFLENETV2_CHANNELS[model_size]
    x = g.relu(g.bn(g.conv(x, f"{p}first_conv.0", stride=2),
                    f"{p}first_conv.1"))
    x = g.maxpool(x)
    in_ch, bi = chans[0], 0
    for si, repeats in enumerate((4, 8, 4)):
        out_ch = chans[si + 1]
        for i in range(repeats):
            if i == 0:
                x = _shuffle_block(g, x, f"{p}features.{bi}", in_ch, out_ch,
                                   out_ch // 2, 3, 2, "relu", False, in_ch)
            else:
                x = _shuffle_block(g, x, f"{p}features.{bi}", in_ch // 2,
                                   out_ch, out_ch // 2, 3, 1, "relu", False,
                                   in_ch)
            in_ch = out_ch
            bi += 1
    return g.relu(g.bn(g.conv(x, f"{p}conv_last.0", pad=0),
                       f"{p}conv_last.1"))


def _emit_shufflenetv2_plus(g: GraphBuilder, x: str, p: str,
                            model_size: str = "Small") -> str:
    from ..models.mobile import (SHUFFLENETV2_PLUS_ARCH,
                                 SHUFFLENETV2_PLUS_CHANNELS)
    chans = SHUFFLENETV2_PLUS_CHANNELS[model_size]
    x = _hswish(g, g.bn(g.conv(x, f"{p}first_conv.0", stride=2),
                        f"{p}first_conv.1"))
    in_ch, ai = chans[0], 0
    for si, repeats in enumerate((4, 4, 8, 4)):
        out_ch = chans[si + 1]
        act = "hs" if si >= 1 else "relu"
        use_se = si >= 2
        for i in range(repeats):
            inp = in_ch if i == 0 else in_ch // 2
            stride = 2 if i == 0 else 1
            btype = SHUFFLENETV2_PLUS_ARCH[ai]
            tp = f"{p}features.{ai}"
            ai += 1
            if btype == 3:
                x = _xception_block(g, x, tp, inp, out_ch, out_ch // 2,
                                    stride, act, use_se, in_ch)
            else:
                ksize = {0: 3, 1: 5, 2: 7}[btype]
                x = _shuffle_block(g, x, tp, inp, out_ch, out_ch // 2,
                                   ksize, stride, act, use_se, in_ch)
            in_ch = out_ch
    return _hswish(g, g.bn(g.conv(x, f"{p}conv_last.0", pad=0),
                           f"{p}conv_last.1"))


# ----------------------------------------------------------- mobilenetv3


def _emit_mobilenetv3_small(g: GraphBuilder, x: str, p: str) -> str:
    """torchvision layout; BN eps 1e-3."""
    from ..models.mobile import MOBILENETV3_SMALL_SPEC
    from ..models.mobile import make_divisible as _make_divisible

    def cna(x, tkey, stride=1, group=1, act="hs"):
        x = g.bn(g.conv(x, f"{tkey}.0", stride=stride, group=group),
                 f"{tkey}.1", eps=1e-3)
        return _act(g, x, act)

    x = cna(x, f"{p}0", stride=2)
    in_ch = 16
    for bi, (exp, out, _k, s, se, act) in enumerate(MOBILENETV3_SMALL_SPEC):
        tb = f"{p}{bi + 1}.block"
        res, j = x, 0
        if exp != in_ch:
            x = cna(x, f"{tb}.{j}", act=act)
            j += 1
        x = cna(x, f"{tb}.{j}", stride=s, group=exp, act=act)
        j += 1
        if se:
            a = g.global_avgpool(x)
            a = g.relu(g.conv(a, f"{tb}.{j}.fc1", pad=0))
            a = g.conv(a, f"{tb}.{j}.fc2", pad=0)
            x = g.mul(x, _hsig(g, a))
            j += 1
        x = cna(x, f"{tb}.{j}", act="none")
        if s == 1 and in_ch == out:
            x = g.add(x, res)
        in_ch = out
    return cna(x, f"{p}12")


# -------------------------------------------------------------- mobilevit


def _cna(g: GraphBuilder, x: str, tkey: str, stride: int = 1,
         group: int = 1, act: bool = True) -> str:
    """corenet ConvLayer: conv [+ BN] [+ SiLU]."""
    x = g.conv(x, f"{tkey}.block.conv", stride=stride, group=group)
    if f"{tkey}.block.norm.weight" in g.sd:
        x = g.bn(x, f"{tkey}.block.norm")
    return _silu(g, x) if act else x


def _mv2(g: GraphBuilder, x: str, tp: str, in_ch: int, out_ch: int,
         stride: int, expand: int) -> str:
    hidden = int(round(in_ch * expand))
    y = x
    if expand != 1:
        y = _cna(g, y, f"{tp}.block.exp_1x1")
    y = _cna(g, y, f"{tp}.block.conv_3x3", stride=stride, group=hidden)
    y = _cna(g, y, f"{tp}.block.red_1x1", act=False)
    if stride == 1 and in_ch == out_ch:
        y = g.add(y, x)
    return y


def _ln_lastdim(g: GraphBuilder, x: str, tp: str, ndim: int,
                eps: float = 1e-5) -> str:
    ax = ndim - 1
    mu = g.node("ReduceMean", [x], axes=[ax], keepdims=1)
    d = g.node("Sub", [x, mu])
    var = g.node("ReduceMean", [g.mul(d, d)], axes=[ax], keepdims=1)
    eps_c = g.const(f"ln_eps_{eps:g}", np.asarray([eps], np.float32))
    y = g.node("Div", [d, g.node("Sqrt", [g.add(var, eps_c)])])
    y = g.mul(y, g.weight(f"{tp}.weight"))
    return g.add(y, g.weight(f"{tp}.bias"))


def _linear(g: GraphBuilder, x: str, tp: str) -> str:
    """torch Linear on the last dim of an N-D tensor (MatMul + Add)."""
    w = g.transpose(g.weight(f"{tp}.weight"), (1, 0))
    y = g.node("MatMul", [x, w])
    return g.add(y, g.weight(f"{tp}.bias"))


def _mha(g: GraphBuilder, p: str, tp: str, bp: int, n: int, d: int,
         heads: int) -> str:
    """corenet MultiHeadAttention (mobilevit.py:369-466): combined qkv,
    q scaled by head_dim**-0.5."""
    hd = d // heads
    qkv = _linear(g, p, f"{tp}.qkv_proj")            # (BP, N, 3d)
    q = g.slice_axis(qkv, 0, d, axis=2)
    k = g.slice_axis(qkv, d, 2 * d, axis=2)
    v = g.slice_axis(qkv, 2 * d, 3 * d, axis=2)

    def split_heads(t):
        return g.transpose(g.reshape(t, (bp, n, heads, hd)), (0, 2, 1, 3))

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scale = g.const(f"mha_scale_{hd}",
                    np.asarray(hd ** -0.5, np.float32))
    attn = g.node("MatMul", [g.mul(q, scale), g.transpose(k, (0, 1, 3, 2))])
    attn = g.node("Softmax", [attn], axis=3)         # tail dim
    ctx = g.node("MatMul", [attn, v])                # (BP, h, N, hd)
    ctx = g.reshape(g.transpose(ctx, (0, 2, 1, 3)), (bp, n, d))
    return _linear(g, ctx, f"{tp}.out_proj")


def _emit_mobilevit(g: GraphBuilder, x: str, p: str, mode: str,
                    hw, batch: int, heads: int = 4) -> str:
    from ..models.mobilevit import MOBILEVIT_SPEC
    exp, l1, l2, l3, l4, l5, last_exp = MOBILEVIT_SPEC[mode]
    h, w = hw
    x = _cna(g, x, f"{p}conv_1", stride=2)
    x = _mv2(g, x, f"{p}layer_1.0", 16, l1, 1, exp)
    in_ch = l1
    for i in range(3):
        x = _mv2(g, x, f"{p}layer_2.{i}", in_ch, l2, 2 if i == 0 else 1, exp)
        in_ch = l2
    ch, cw = h // 4, w // 4
    for li, spec in zip((3, 4, 5), (l3, l4, l5)):
        out, d, ffn, L = spec
        x = _mv2(g, x, f"{p}layer_{li}.0", in_ch, out, 2, exp)
        in_ch = out
        ch, cw = ch // 2, cw // 2
        assert ch % 2 == 0 and cw % 2 == 0, \
            f"mobilevit export needs patch-divisible sizes, got {ch}x{cw}"
        tp = f"{p}layer_{li}.1"
        res = x
        fm = _cna(g, x, f"{tp}.local_rep.conv_3x3")
        fm = g.conv(fm, f"{tp}.local_rep.conv_1x1.block.conv", pad=0)
        # unfold (B,d,H,W) → (B·P, N, d); P=4 (2×2), N=(H/2)(W/2)
        nh, nw = ch // 2, cw // 2
        bp, n_pos = batch * 4, nh * nw
        t = g.reshape(fm, (batch, d, nh, 2, nw, 2))
        t = g.transpose(t, (0, 3, 5, 2, 4, 1))       # B,ph,pw,nh,nw,d
        pt = g.reshape(t, (bp, n_pos, d))
        for b in range(L):
            base = f"{tp}.global_rep.{b}"
            hdn = _ln_lastdim(g, pt, f"{base}.pre_norm_mha.0", 3)
            pt = g.add(pt, _mha(g, hdn, f"{base}.pre_norm_mha.1",
                                bp, n_pos, d, heads))
            hdn = _ln_lastdim(g, pt, f"{base}.pre_norm_ffn.0", 3)
            hdn = _silu(g, _linear(g, hdn, f"{base}.pre_norm_ffn.1"))
            pt = g.add(pt, _linear(g, hdn, f"{base}.pre_norm_ffn.4"))
        pt = _ln_lastdim(g, pt, f"{tp}.global_rep.{L}", 3)
        # fold back
        t = g.reshape(pt, (batch, 2, 2, nh, nw, d))
        t = g.transpose(t, (0, 5, 3, 1, 4, 2))       # B,d,nh,ph,nw,pw
        fm = g.reshape(t, (batch, d, ch, cw))
        fm = _cna(g, fm, f"{tp}.conv_proj")
        x = _cna(g, g.concat([res, fm]), f"{tp}.fusion")
    return _cna(g, x, f"{p}conv_1x1_exp")


def _groupnorm1(g: GraphBuilder, x: str, tp: str, channels: int,
                eps: float = 1e-5) -> str:
    """corenet layer_norm_2d == GroupNorm(1) on (B,C,P,N)."""
    mu = g.node("ReduceMean", [x], axes=[1, 2, 3], keepdims=1)
    d = g.node("Sub", [x, mu])
    var = g.node("ReduceMean", [g.mul(d, d)], axes=[1, 2, 3], keepdims=1)
    eps_c = g.const(f"ln_eps_{eps:g}", np.asarray([eps], np.float32))
    y = g.node("Div", [d, g.node("Sqrt", [g.add(var, eps_c)])])
    y = g.mul(y, g.reshape(g.weight(f"{tp}.weight"), (1, channels, 1, 1)))
    return g.add(y, g.reshape(g.weight(f"{tp}.bias"), (1, channels, 1, 1)))


def _emit_mobilevitv2(g: GraphBuilder, x: str, p: str, width: float,
                      hw, batch: int) -> str:
    from ..models.mobile import make_divisible as _make_divisible
    h, w = hw
    stem = _make_divisible(max(16, min(64, 32 * width)), 8, 16)
    l1 = _make_divisible(64 * width, 16)
    l2 = _make_divisible(128 * width, 8)
    specs = [
        (_make_divisible(256 * width, 8), _make_divisible(128 * width, 8), 2),
        (_make_divisible(384 * width, 8), _make_divisible(192 * width, 8), 4),
        (_make_divisible(512 * width, 8), _make_divisible(256 * width, 8), 3),
    ]
    x = _cna(g, x, f"{p}conv_1", stride=2)
    x = _mv2(g, x, f"{p}layer_1.0", stem, l1, 1, 2)
    in_ch = l1
    for i in range(2):
        x = _mv2(g, x, f"{p}layer_2.{i}", in_ch, l2, 2 if i == 0 else 1, 2)
        in_ch = l2
    ch, cw = h // 4, w // 4
    for li, (out, d, L) in zip((3, 4, 5), specs):
        x = _mv2(g, x, f"{p}layer_{li}.0", in_ch, out, 2, 2)
        in_ch = out
        ch, cw = ch // 2, cw // 2
        assert ch % 2 == 0 and cw % 2 == 0, \
            f"mobilevitv2 export needs patch-divisible sizes, got {ch}x{cw}"
        tp = f"{p}layer_{li}.1"
        fm = _cna(g, x, f"{tp}.local_rep.0", group=in_ch)
        fm = g.conv(fm, f"{tp}.local_rep.1.block.conv", pad=0)
        nh, nw = ch // 2, cw // 2
        n_pos = nh * nw
        # unfold (B,d,H,W) → (B,d,P,N)
        t = g.reshape(fm, (batch, d, nh, 2, nw, 2))
        t = g.transpose(t, (0, 1, 3, 5, 2, 4))       # B,d,ph,pw,nh,nw
        pt = g.reshape(t, (batch, d, 4, n_pos))
        for b in range(L):
            base = f"{tp}.global_rep.{b}"
            hdn = _groupnorm1(g, pt, f"{base}.pre_norm_attn.0", d)
            qkv = g.conv(hdn, f"{base}.pre_norm_attn.1.qkv_proj.block.conv",
                         pad=0)
            q, k, v = g.split(qkv, (1, d, d), axis=1)
            scores = g.node("Softmax", [q], axis=3)  # over patch positions
            ctx = g.node("ReduceSum", [g.mul(k, scores)],
                         axes=[3], keepdims=1)
            o = g.mul(g.relu(v), ctx)
            o = g.conv(o, f"{base}.pre_norm_attn.1.out_proj.block.conv",
                       pad=0)
            pt = g.add(pt, o)
            hdn = _groupnorm1(g, pt, f"{base}.pre_norm_ffn.0", d)
            hdn = _silu(g, g.conv(hdn, f"{base}.pre_norm_ffn.1.block.conv",
                                  pad=0))
            pt = g.add(pt, g.conv(hdn, f"{base}.pre_norm_ffn.3.block.conv",
                                  pad=0))
        pt = _groupnorm1(g, pt, f"{tp}.global_rep.{L}", d)
        # fold back
        t = g.reshape(pt, (batch, d, 2, 2, nh, nw))
        t = g.transpose(t, (0, 1, 4, 2, 5, 3))       # B,d,nh,ph,nw,pw
        fm = g.reshape(t, (batch, d, ch, cw))
        x = _cna(g, fm, f"{tp}.conv_proj", act=False)
        in_ch = out
    return x


# ------------------------------------------------------------------ heads


def _pixel_shuffle_head(g: GraphBuilder, x: str, n_duc: int):
    x = g.conv(x, "decoder.conv_compress", pad=0)
    for i in range(n_duc):
        x = g.relu(g.bn(g.conv(x, f"decoder.duc.{i}.conv"),
                        f"decoder.duc.{i}.bn"))
        x = g.depth_to_space(x, 2)
    return x, n_duc


# -------------------------------------------------------------- top level


def build_pose_mobile(sd: Dict[str, np.ndarray], cfg,
                      batch: int = 1) -> bytes:
    """Any mobile registry pose net → ONNX bytes."""
    name = cfg.MODEL.NAME
    extra = cfg.MODEL.EXTRA
    w, h = int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1])
    g = GraphBuilder(sd, name)

    if "shufflenetv2_plus" in name:
        feats = _emit_shufflenetv2_plus(
            g, "images", "backbone.", extra.get("MODEL_SIZE", "Small"))
    elif "shufflenetv2_10x" in name:
        feats = _emit_shufflenetv2(
            g, "images", "backbone.", extra.get("MODEL_SIZE", "1.0x"))
    elif "mobilenetv3_small" in name:
        feats = _emit_mobilenetv3_small(g, "images", "backbone.0.")
    elif "mobilevitv2" in name:
        from ..models.pose_mobile import mvitv2_width
        feats = _emit_mobilevitv2(g, "images", "backbone.",
                                  mvitv2_width(cfg), (h, w), batch)
    elif "mobilevit" in name:
        from ..models.pose_mobile import mvit_mode
        feats = _emit_mobilevit(g, "images", "backbone.",
                                mvit_mode(cfg), (h, w), batch)
    else:
        raise KeyError(f"not a mobile pose model: {name!r}")

    if "pixel_shuffle" in name:
        arch = tuple(extra.get("ARCHITECTURE", (512, 256, 128)))
        x, ups = _pixel_shuffle_head(g, feats, len(arch))
    else:
        x, ups = _deconv_head(g, feats)
    fk = extra.get("FINAL_CONV_KERNEL", 1)
    x = g.conv(x, "final_layer", pad=1 if fk == 3 else 0, out="output")

    out_ch = (cfg.MODEL.NUM_JOINTS * 3
              if cfg.MODEL.TARGET_TYPE == "offset" else cfg.MODEL.NUM_JOINTS)
    oh, ow = h // 32 * (2 ** ups), w // 32 * (2 ** ups)
    return g.finish("images", (batch, 3, h, w), "output",
                    (batch, out_ch, oh, ow), doc=f"{name} {w}x{h}")
