"""MobileViT and MobileViTv2 backbones in PyTorch, NCHW, with stock torch
ops (the JAX package has no kernel here).

Port of ``udp_pose_tpu/models/mobilevit.py``:

* MobileViT (backbones/mobilevit.py): MV2 inverted residuals and
  MobileViT blocks (:517-679): local 3×3 + 1×1, a pre-norm transformer
  over the patch positions of each intra-patch pixel, fold, 1×1
  projection, 3×3 fusion of the concatenation; swish; 4 heads; the
  xxs/xs/s widths of ``MOBILEVIT_SPEC``.
* MobileViTv2 (backbones/mobilevitv2.py): depthwise local
  representation, separable linear attention (:547-690: a softmax over
  the patch positions of a 1-channel query, the scored sum of the keys,
  ``relu(value) · context``), ``LayerNorm2D`` (a per-sample
  ``GroupNorm(1)``), the width multipliers of configs/mobilevitv2.py.

Attribute names give corenet's state-dict keys: ``conv_1.block.conv`` /
``.block.norm``, ``layer_{i}.{j}.block.exp_1x1`` ..., the MobileViT
block's ``local_rep``, ``global_rep.{b}.pre_norm_mha.{0,1}`` /
``pre_norm_ffn.{0,1,4}`` (v1) or ``pre_norm_attn.{0,1}`` /
``pre_norm_ffn.{0,1,3}`` (v2), ``conv_proj`` and ``fusion``.  The
attention holds corenet's combined ``qkv_proj`` (rows q; k; v).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d
from .mobile import make_divisible


class ConvLayer(nn.Module):
    """corenet ConvLayer (``block.conv`` [+ ``block.norm``] [+ swish]),
    the JAX package's ``ConvNormAct``: "same" padding, a bias only
    without the norm unless ``bias`` says otherwise."""

    def __init__(self, in_ch, out_ch, kernel=1, stride=1, groups=1,
                 norm=True, act=True, bias=None):
        super().__init__()
        bias = (not norm) if bias is None else bias
        layers = OrderedDict(conv=nn.Conv2d(
            in_ch, out_ch, kernel, stride, (kernel - 1) // 2, groups=groups,
            bias=bias))
        if norm:
            layers["norm"] = BatchNorm2d(out_ch)
        if act:
            layers["act"] = nn.SiLU()
        self.block = nn.Sequential(layers)

    def forward(self, x):
        return self.block(x)


class MV2Block(nn.Module):
    """corenet InvertedResidual: [exp_1x1] → depthwise conv_3x3 →
    red_1x1, the residual when stride 1 keeps the width."""

    def __init__(self, in_ch, out_ch, stride=1, expand_ratio=4):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        layers = OrderedDict()
        if expand_ratio != 1:
            layers["exp_1x1"] = ConvLayer(in_ch, hidden)
        layers["conv_3x3"] = ConvLayer(hidden, hidden, 3, stride,
                                       groups=hidden)
        layers["red_1x1"] = ConvLayer(hidden, out_ch, act=False)
        self.block = nn.Sequential(layers)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = self.block(x)
        return y + x if self.residual else y


def _resize(x, hw):
    """Bilinear resize without antialiasing, half-pixel centres
    (``jax.image.resize(..., "bilinear", antialias=False)``)."""
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def unfold_patches(x, ph, pw):
    """(B, C, H, W) → (B, C, P, N): P the intra-patch pixel (row-major),
    N the patch position (row-major).  Sizes that are not multiples of
    the patch are resized up to the next multiple first."""
    B, C, H, W = x.shape
    nh, nw = -(-H // ph), -(-W // pw)
    if (nh * ph, nw * pw) != (H, W):
        x = _resize(x, (nh * ph, nw * pw))
    x = x.reshape(B, C, nh, ph, nw, pw).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, C, ph * pw, nh * nw)


def fold_patches(p, hw, ph, pw):
    """The inverse of :func:`unfold_patches`, resized back to ``hw``."""
    B, C, P, N = p.shape
    H, W = hw
    nh, nw = -(-H // ph), -(-W // pw)
    x = p.reshape(B, C, ph, pw, nh, nw).permute(0, 1, 4, 2, 5, 3)
    x = x.reshape(B, C, nh * ph, nw * pw)
    if (nh * ph, nw * pw) != (H, W):
        x = _resize(x, (H, W))
    return x


class MultiHeadAttention(nn.Module):
    """corenet MultiHeadAttention (backbones/mobilevit.py:369-466), the
    JAX package's flax ``MultiHeadDotProductAttention``: combined
    ``qkv_proj`` (rows q; k; v, heads contiguous), queries scaled by
    1/√(head dim), softmax over the keys, ``out_proj``."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, d = x.shape
        hd = d // self.heads
        q, k, v = self.qkv_proj(x).reshape(B, N, 3, self.heads,
                                           hd).permute(2, 0, 3, 1, 4)
        w = torch.softmax((q / hd ** 0.5) @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, N, d))


class TransformerEncoder(nn.Module):
    """Pre-norm attention and swish FFN (mobilevit.py:469-514)."""

    def __init__(self, dim, ffn_dim, heads=4):
        super().__init__()
        self.pre_norm_mha = nn.Sequential(nn.LayerNorm(dim),
                                          MultiHeadAttention(dim, heads))
        self.pre_norm_ffn = nn.Sequential(
            nn.LayerNorm(dim), nn.Linear(dim, ffn_dim), nn.SiLU(),
            nn.Identity(), nn.Linear(ffn_dim, dim), nn.Identity())

    def forward(self, x):
        x = x + self.pre_norm_mha(x)
        return x + self.pre_norm_ffn(x)


class MobileViTBlock(nn.Module):
    """mobilevit.py:517-679."""

    def __init__(self, in_ch, dim, ffn_dim, n_blocks=2, heads=4,
                 patch=(2, 2)):
        super().__init__()
        self.patch = patch
        self.local_rep = nn.Sequential(OrderedDict(
            conv_3x3=ConvLayer(in_ch, in_ch, 3),
            conv_1x1=ConvLayer(in_ch, dim, norm=False, act=False,
                               bias=False)))
        self.global_rep = nn.Sequential(
            *[TransformerEncoder(dim, ffn_dim, heads)
              for _ in range(n_blocks)], nn.LayerNorm(dim))
        self.conv_proj = ConvLayer(dim, in_ch)
        self.fusion = ConvLayer(2 * in_ch, in_ch, 3)

    def forward(self, x):
        ph, pw = self.patch
        fm = self.local_rep(x)
        H, W = fm.shape[2:]
        p = unfold_patches(fm, ph, pw)                  # (B, d, P, N)
        B, d, P, N = p.shape
        p = self.global_rep(p.permute(0, 2, 3, 1).reshape(B * P, N, d))
        fm = fold_patches(p.reshape(B, P, N, d).permute(0, 3, 1, 2),
                          (H, W), ph, pw)
        return self.fusion(torch.cat([x, self.conv_proj(fm)], dim=1))


MOBILEVIT_SPEC = {
    # (mv2_exp, l1_out, l2_out, (l3 out, d, ffn, L), (l4 ...), (l5 ...),
    #  last_exp)
    "xx_small": (2, 16, 24, (48, 64, 128, 2), (64, 80, 160, 4),
                 (80, 96, 192, 3), 4),
    "x_small": (4, 32, 48, (64, 96, 192, 2), (80, 120, 240, 4),
                (96, 144, 288, 3), 4),
    "small": (4, 32, 64, (96, 144, 288, 2), (128, 192, 384, 4),
              (160, 240, 480, 3), 4),
}


class MobileViT(nn.Module):
    """The backbone to stride-32 features after the expanding 1×1 conv
    (640 / 384 / 320 channels for s / xs / xxs)."""

    def __init__(self, mode: str = "small", heads: int = 4):
        super().__init__()
        exp, l1, l2, l3, l4, l5, last_exp = MOBILEVIT_SPEC[mode]
        self.conv_1 = ConvLayer(3, 16, 3, 2)
        self.layer_1 = nn.Sequential(MV2Block(16, l1, 1, exp))
        self.layer_2 = nn.Sequential(*[MV2Block(l1 if i == 0 else l2, l2,
                                                2 if i == 0 else 1, exp)
                                       for i in range(3)])
        in_ch = l2
        for li, (out, d, ffn, L) in zip((3, 4, 5), (l3, l4, l5)):
            setattr(self, f"layer_{li}", nn.Sequential(
                MV2Block(in_ch, out, 2, exp),
                MobileViTBlock(out, d, ffn, L, heads)))
            in_ch = out
        self.conv_1x1_exp = ConvLayer(in_ch, l5[0] * last_exp)
        self.out_channels = l5[0] * last_exp

    def forward(self, x):
        x = self.layer_2(self.layer_1(self.conv_1(x)))
        x = self.layer_5(self.layer_4(self.layer_3(x)))
        return self.conv_1x1_exp(x)


# ---------------------------------------------------------------------------
# MobileViTv2
# ---------------------------------------------------------------------------

class LayerNorm2D(nn.GroupNorm):
    """corenet ``layer_norm_2d``: ``GroupNorm(1)``, per-sample statistics
    over every non-batch dimension, a per-channel affine; eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__(1, channels, eps=1e-5)


class LinearSelfAttention(nn.Module):
    """mobilevitv2.py:547-690 on (B, d, P, N): ``qkv_proj`` to 1 + 2d
    channels, a softmax of the query over the patch positions N, the
    context ``Σ_N scores · key``, ``relu(value) · context``,
    ``out_proj``."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.qkv_proj = ConvLayer(dim, 1 + 2 * dim, norm=False, act=False,
                                  bias=True)
        self.out_proj = ConvLayer(dim, dim, norm=False, act=False, bias=True)

    def forward(self, x):
        qkv = self.qkv_proj(x)
        q, k, v = torch.split(qkv, (1, self.dim, self.dim), dim=1)
        scores = torch.softmax(q, dim=-1)
        ctx = (k * scores).sum(dim=-1, keepdim=True)
        return self.out_proj(F.relu(v) * ctx)


class LinearAttnFFN(nn.Module):
    """mobilevitv2.py:748-840: pre-norm linear attention and a 1×1-conv
    FFN with swish."""

    def __init__(self, dim, ffn_dim):
        super().__init__()
        self.pre_norm_attn = nn.Sequential(LayerNorm2D(dim),
                                           LinearSelfAttention(dim))
        self.pre_norm_ffn = nn.Sequential(
            LayerNorm2D(dim),
            ConvLayer(dim, ffn_dim, norm=False, act=True, bias=True),
            nn.Identity(),
            ConvLayer(ffn_dim, dim, norm=False, act=False, bias=True),
            nn.Identity())

    def forward(self, x):
        x = x + self.pre_norm_attn(x)
        return x + self.pre_norm_ffn(x)


def _interp_matrix(n_in, n_out, device, dtype):
    """The JAX package's align-corners interpolation matrix (n_out,
    n_in): rows of (1 - w, w) at ``pos = o · (n_in - 1) / (n_out - 1)``;
    where ``n_in`` or ``n_out`` is 1, every row is the average 1/n_in
    (torch's ``align_corners=True`` takes index 0 for ``n_out`` 1)."""
    if n_out == 1 or n_in == 1:
        return torch.full((n_out, n_in), 1.0 / n_in, device=device,
                          dtype=dtype)
    pos = (torch.arange(n_out, device=device, dtype=torch.float32)
           * (n_in - 1) / (n_out - 1))
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    w = pos - lo
    m = torch.zeros((n_out, n_in), device=device, dtype=torch.float32)
    rows = torch.arange(n_out, device=device)
    m.index_put_((rows, lo), 1 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m.to(dtype)


def resize_align_corners(x, size):
    """(B, C, H, W) → (B, C, *size): bilinear with align-corners
    semantics as two float32 matrix products, the JAX package's
    ``_resize_align_corners``."""
    H, W = x.shape[2:]
    mh = _interp_matrix(H, size[0], x.device, torch.float32)
    mw = _interp_matrix(W, size[1], x.device, torch.float32)
    y = torch.einsum("oh,bchw->bcow", mh, x.float())
    y = torch.einsum("pw,bcow->bcop", mw, y)
    return y.to(x.dtype)


class MobileViTBlockv2(nn.Module):
    """mobilevitv2.py:858-1040: depthwise local representation, linear
    attention over patches, 1×1 projection (no fusion).  An input that
    is not a multiple of the patch is resized up first (align corners,
    resize_input_if_needed :1095-1103) and the output keeps that size."""

    def __init__(self, in_ch, dim, ffn_dim, n_blocks=2, patch=(2, 2)):
        super().__init__()
        self.patch = patch
        self.local_rep = nn.Sequential(
            ConvLayer(in_ch, in_ch, 3, groups=in_ch),
            ConvLayer(in_ch, dim, norm=False, act=False, bias=False))
        self.global_rep = nn.Sequential(
            *[LinearAttnFFN(dim, ffn_dim) for _ in range(n_blocks)],
            LayerNorm2D(dim))
        self.conv_proj = ConvLayer(dim, in_ch, act=False)

    def forward(self, x):
        ph, pw = self.patch
        H, W = x.shape[2:]
        nh, nw = -(-H // ph) * ph, -(-W // pw) * pw
        if (nh, nw) != (H, W):
            x = resize_align_corners(x, (nh, nw))
        p = self.global_rep(unfold_patches(self.local_rep(x), ph, pw))
        return self.conv_proj(fold_patches(p, (nh, nw), ph, pw))


class MobileViTv2(nn.Module):
    """The width-multiplier family (0.5 / 0.75 / 1.0) to stride-32
    features."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        w = width
        stem = make_divisible(max(16, min(64, 32 * w)), 8, 16)
        l1 = make_divisible(64 * w, 16)
        l2 = make_divisible(128 * w, 8)
        specs = [(make_divisible(256 * w, 8), make_divisible(128 * w, 8), 2),
                 (make_divisible(384 * w, 8), make_divisible(192 * w, 8), 4),
                 (make_divisible(512 * w, 8), make_divisible(256 * w, 8), 3)]
        self.conv_1 = ConvLayer(3, stem, 3, 2)
        self.layer_1 = nn.Sequential(MV2Block(stem, l1, 1, 2))
        self.layer_2 = nn.Sequential(MV2Block(l1, l2, 2, 2),
                                     MV2Block(l2, l2, 1, 2))
        in_ch = l2
        for li, (out, d, L) in zip((3, 4, 5), specs):
            ffn = int((2 * d) // 16 * 16)
            setattr(self, f"layer_{li}", nn.Sequential(
                MV2Block(in_ch, out, 2, 2),
                MobileViTBlockv2(out, d, ffn, L)))
            in_ch = out
        self.out_channels = in_ch

    def forward(self, x):
        x = self.layer_2(self.layer_1(self.conv_1(x)))
        return self.layer_5(self.layer_4(self.layer_3(x)))
