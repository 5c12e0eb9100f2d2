"""Weights into the port: JAX-package variables, reference ``.pth`` and
ultralytics YOLOv5 state dicts.

The port's own copy of the reverse half of
``udp_pose_tpu/utils/torch_convert.py`` (``Converter(reverse=True)``, the
HRNet and SimpleBaseline mappings ``_map_pose_hrnet`` and
``_map_pose_resnet`` with their PSA inserts, the RSN mapping
``_map_rsn``, the mobile nets' ``_map_pose_mobile`` and the YOLOv5
mapping ``_map_yolov5``): it walks the JAX
package's flax variables — nested dicts of numpy arrays under
``params`` and ``batch_stats`` — and emits
the reference torch state_dict, whose keys are the port's module names.
Layout rules: flax conv kernel (kh, kw, I, O) → torch Conv2d
(O, I, kh, kw), or for a transposed conv the spatially flipped
ConvTranspose2d (I, O, kh, kw); BatchNorm scale/bias → weight/bias,
batch_stats mean/var → running_mean/running_var; LayerNorm scale/bias →
weight/bias, (C, 1, 1) for the PSA LayerNorm([C, 1, 1]); flax Dense
kernel (I, O) → torch Linear (O, I); flax multi-head attention
(query/key/value (dim, heads, head dim), out (heads, head dim, dim)) →
corenet's combined ``qkv_proj`` (rows q; k; v) and ``out_proj``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (bare weights or a checkpoint dict) →
    {name: numpy array}, DataParallel ``module.`` prefixes stripped."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    if isinstance(blob, dict) and "best_state_dict" in blob:
        blob = blob["best_state_dict"]
    out = {}
    for k, v in blob.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy()
    return out


def conv_kernel_inv(k):
    """flax (kh, kw, I, O) → torch Conv2d (O, I, kh, kw)."""
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def convT_kernel_inv(k):
    """flax (kh, kw, I, O) → torch ConvTranspose2d (I, O, kh, kw)."""
    return np.ascontiguousarray(
        np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _has(tree, path):
    node = tree
    for p in path:
        if not hasattr(node, "keys") or p not in node:
            return False
        node = node[p]
    return True


class Converter:
    """flax path → torch key emitter: walks a family mapping, reading the
    flax variables and writing a reference-format torch state_dict."""

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: Dict[str, np.ndarray] = {}

    def probe(self, tkey: str, *fpath) -> bool:
        """Does the flax tree hold the module at ``fpath``?"""
        return _has(self.params, fpath)

    def conv(self, tkey: str, *path, transposed=False):
        k = _get(self.params, (*path, "kernel"))
        self.sd[tkey + ".weight"] = (convT_kernel_inv(k) if transposed
                                     else conv_kernel_inv(k))
        if _has(self.params, (*path, "bias")):
            self.sd[tkey + ".bias"] = _get(self.params, (*path, "bias"))

    def bn(self, tkey: str, *path):
        self.sd[f"{tkey}.weight"] = _get(self.params, (*path, "scale"))
        self.sd[f"{tkey}.bias"] = _get(self.params, (*path, "bias"))
        self.sd[f"{tkey}.running_mean"] = _get(self.stats, (*path, "mean"))
        self.sd[f"{tkey}.running_var"] = _get(self.stats, (*path, "var"))
        self.sd[f"{tkey}.num_batches_tracked"] = np.array(0, np.int64)

    def dense(self, tkey: str, *path):
        """flax Dense kernel (I, O) → torch Linear weight (O, I)."""
        self.sd[tkey + ".weight"] = np.ascontiguousarray(
            _get(self.params, (*path, "kernel")).T)
        if _has(self.params, (*path, "bias")):
            self.sd[tkey + ".bias"] = _get(self.params, (*path, "bias"))

    def ln(self, tkey: str, *path, tshape=None):
        """``tshape="c11"``: the torch LayerNorm([C, 1, 1]) of PSA
        (PSA.py:164), whose weight and bias are (C, 1, 1)."""
        w = _get(self.params, (*path, "scale"))
        b = _get(self.params, (*path, "bias"))
        if tshape == "c11":
            w, b = w.reshape(-1, 1, 1), b.reshape(-1, 1, 1)
        self.sd[tkey + ".weight"] = w
        self.sd[tkey + ".bias"] = b

    def mha(self, tkey: str, *path):
        """flax ``MultiHeadDotProductAttention`` at ``path`` → corenet's
        ``qkv_proj`` / ``out_proj`` Linears
        (``utils/torch_convert.py:_convert_mha`` there)."""
        ws, bs = [], []
        for name in ("query", "key", "value"):
            k = _get(self.params, (*path, name, "kernel"))
            dim = k.shape[0]
            ws.append(k.reshape(dim, dim).T)
            bs.append(_get(self.params, (*path, name, "bias")).reshape(dim))
        self.sd[tkey + ".qkv_proj.weight"] = np.ascontiguousarray(
            np.concatenate(ws, axis=0))
        self.sd[tkey + ".qkv_proj.bias"] = np.concatenate(bs, axis=0)
        ko = _get(self.params, (*path, "out", "kernel"))
        self.sd[tkey + ".out_proj.weight"] = np.ascontiguousarray(
            ko.reshape(-1, ko.shape[-1]).T)
        self.sd[tkey + ".out_proj.bias"] = _get(self.params,
                                                (*path, "out", "bias"))


def _convert_psa(cv, tprefix, *path):
    """PSA_s weights (PSA.py:146-269)."""
    for name in ("conv_q_right", "conv_v_right", "conv_q_left",
                 "conv_v_left"):
        cv.conv(f"{tprefix}.{name}", *path, name)
    cv.conv(f"{tprefix}.conv_up.0", *path, "conv_up_fc1")
    cv.ln(f"{tprefix}.conv_up.1", *path, "conv_up_ln", tshape="c11")
    cv.conv(f"{tprefix}.conv_up.3", *path, "conv_up_fc2")


def _convert_basic_block(cv, tprefix, fpath, psa=False):
    cv.conv(f"{tprefix}.conv1", *fpath, "cb1", "conv")
    cv.bn(f"{tprefix}.bn1", *fpath, "cb1", "bn")
    cv.conv(f"{tprefix}.conv2", *fpath, "cb2", "conv")
    cv.bn(f"{tprefix}.bn2", *fpath, "cb2", "bn")
    if psa and cv.probe(f"{tprefix}.deattn.conv_q_right.weight",
                        *fpath, "deattn"):
        _convert_psa(cv, f"{tprefix}.deattn", *fpath, "deattn")
    if cv.probe(f"{tprefix}.downsample.0.weight", *fpath, "down"):
        cv.conv(f"{tprefix}.downsample.0", *fpath, "down", "conv")
        cv.bn(f"{tprefix}.downsample.1", *fpath, "down", "bn")


def _convert_bottleneck(cv, tprefix, fpath):
    for i in (1, 2, 3):
        cv.conv(f"{tprefix}.conv{i}", *fpath, f"cb{i}", "conv")
        cv.bn(f"{tprefix}.bn{i}", *fpath, f"cb{i}", "bn")
    if cv.probe(f"{tprefix}.downsample.0.weight", *fpath, "down"):
        cv.conv(f"{tprefix}.downsample.0", *fpath, "down", "conv")
        cv.bn(f"{tprefix}.downsample.1", *fpath, "down", "bn")


def _map_pose_resnet(cv: Converter, num_layers: int, psa: bool = False):
    """The reference pose_resnet key layout (deep_hrnet/lib/models/
    pose_resnet.py) against the JAX package's module names."""
    from ..models.resnet import RESNET_SPEC
    _, layers = RESNET_SPEC[num_layers]
    bottleneck = num_layers >= 50
    cv.conv("conv1", "backbone", "conv1")
    cv.bn("bn1", "backbone", "bn1")
    for li, blocks in enumerate(layers):
        for bi in range(blocks):
            tp = f"layer{li + 1}.{bi}"
            fp = ("backbone", f"layer{li + 1}_{bi}")
            if bottleneck:
                _convert_bottleneck(cv, tp, fp)
            else:
                _convert_basic_block(cv, tp, fp, psa=psa)
    i = di = 0
    while cv.probe(f"deconv_layers.{i}.weight", "deconv", f"deconv{di}"):
        cv.conv(f"deconv_layers.{i}", "deconv", f"deconv{di}",
                transposed=True)
        cv.bn(f"deconv_layers.{i + 1}", "deconv", f"bn{di}")
        i += 3
        di += 1
    cv.conv("final_layer", "final_layer")


def _map_pose_hrnet(cv: Converter, stages_cfg, psa: bool = False):
    """The reference pose_hrnet key layout (deep_hrnet/lib/models/
    pose_hrnet.py) against the JAX package's module names."""
    cv.conv("conv1", "stem1", "conv")
    cv.bn("bn1", "stem1", "bn")
    cv.conv("conv2", "stem2", "conv")
    cv.bn("bn2", "stem2", "bn")
    for bi in range(4):
        _convert_bottleneck(cv, f"layer1.{bi}", (f"layer1_{bi}",))

    for si, (num_modules, nb, block, num_blocks, _) in enumerate(stages_cfg):
        t = si + 1  # transition index
        for i in range(nb):
            if cv.probe(f"transition{t}.{i}.0.weight", f"transition{t}_{i}"):
                # single Sequential(Conv, BN, ReLU): channel-change branch
                cv.conv(f"transition{t}.{i}.0", f"transition{t}_{i}", "conv")
                cv.bn(f"transition{t}.{i}.1", f"transition{t}_{i}", "bn")
            else:
                j = 0
                while cv.probe(f"transition{t}.{i}.{j}.0.weight",
                               f"transition{t}_{i}_{j}"):
                    cv.conv(f"transition{t}.{i}.{j}.0",
                            f"transition{t}_{i}_{j}", "conv")
                    cv.bn(f"transition{t}.{i}.{j}.1",
                          f"transition{t}_{i}_{j}", "bn")
                    j += 1
        for mi in range(num_modules):
            tmod = f"stage{si + 2}.{mi}"
            fmod = f"stage{si + 2}_{mi}"
            for br in range(nb):
                for bi in range(num_blocks[br]):
                    tp = f"{tmod}.branches.{br}.{bi}"
                    fp = (fmod, f"branch{br}_{bi}")
                    if block == "BASIC":
                        _convert_basic_block(cv, tp, fp, psa=psa)
                    else:
                        _convert_bottleneck(cv, tp, fp)
            for i in range(nb):
                for j in range(nb):
                    base = f"{tmod}.fuse_layers.{i}.{j}"
                    if j > i and cv.probe(f"{base}.0.weight",
                                          fmod, f"fuse{i}_{j}"):
                        cv.conv(f"{base}.0", fmod, f"fuse{i}_{j}")
                        cv.bn(f"{base}.1", fmod, f"fuse{i}_{j}_bn")
                    elif j == i and cv.probe(f"{base}.0.weight",
                                             fmod, f"fuse{i}_{j}"):
                        # last-module widening 1x1 (no BN)
                        cv.conv(f"{base}.0", fmod, f"fuse{i}_{j}")
                    elif j < i:
                        k = 0
                        while cv.probe(f"{base}.{k}.0.weight",
                                       fmod, f"fuse{i}_{j}_{k}"):
                            cv.conv(f"{base}.{k}.0", fmod, f"fuse{i}_{j}_{k}")
                            cv.bn(f"{base}.{k}.1", fmod,
                                  f"fuse{i}_{j}_{k}_bn")
                            k += 1
    cv.conv("final_layer", "final_layer")


def _convert_cbr(cv, tprefix, *path):
    """RSN conv_bn_relu: the conv (with bias) and its BatchNorm."""
    cv.conv(f"{tprefix}.conv", *path, "conv")
    cv.bn(f"{tprefix}.bn", *path, "bn")


_RSN_STEPS = ("cbr2_1_1", "cbr2_2_1", "cbr2_2_2", "cbr2_3_1", "cbr2_3_2",
              "cbr2_3_3", "cbr2_4_1", "cbr2_4_2", "cbr2_4_3", "cbr2_4_4")
_PRM_NAMES = {"conv_bn_relu_prm_1": "prm1", "conv_bn_relu_prm_2_1": "prm2_1",
              "conv_bn_relu_prm_2_2": "prm2_2",
              "conv_bn_relu_prm_3_1": "prm3_1",
              "conv_bn_relu_prm_3_2": "prm3_2"}


def _map_rsn(cv: Converter, stage_num: int, layers=(2, 2, 2, 2),
             plain=False, se=False, prm=False):
    """The reference RSN key layout (RSN/exps/*/network.py) against the
    JAX package's module names."""
    if cv.probe("top.conv.0.conv.weight", "top_conv0"):
        # the SE/PRM experiment's 3-conv stem (its network.py:188-202)
        for i in range(3):
            _convert_cbr(cv, f"top.conv.{i}", f"top_conv{i}")
    else:
        _convert_cbr(cv, "top.conv", "top")
    for si in range(stage_num):
        td, fd = f"stage{si}.downsample", f"stage{si}_down"
        for li, blocks in enumerate(layers):
            for bi in range(blocks):
                tb = f"{td}.layer{li + 1}.{bi}"
                fb = (fd, f"layer{li + 1}_{bi}")
                if plain:
                    for i in (1, 2, 3):
                        _convert_cbr(cv, f"{tb}.conv_bn_relu{i}", *fb,
                                     f"cbr{i}")
                else:
                    _convert_cbr(cv, f"{tb}.conv_bn_relu1", *fb, "cbr1")
                    for s in _RSN_STEPS:
                        tname = s.replace("cbr", "conv_bn_relu")
                        _convert_cbr(cv, f"{tb}.{tname}", *fb, s)
                    _convert_cbr(cv, f"{tb}.conv_bn_relu3", *fb, "cbr3")
                if cv.probe(f"{tb}.downsample.conv.weight", *fb, "down"):
                    _convert_cbr(cv, f"{tb}.downsample", *fb, "down")
                if se and cv.probe(f"{tb}.se.fc.0.weight", *fb, "se"):
                    cv.dense(f"{tb}.se.fc.0", *fb, "se", "fc1")
                    cv.dense(f"{tb}.se.fc.2", *fb, "se", "fc2")
        tu, fu = f"stage{si}.upsample", f"stage{si}_up"
        for ui in range(1, 5):
            tup, fup = f"{tu}.up{ui}", (fu, f"up{ui}")
            _convert_cbr(cv, f"{tup}.u_skip", *fup, "u_skip")
            if ui > 1:
                _convert_cbr(cv, f"{tup}.up_conv", *fup, "up_conv")
            _convert_cbr(cv, f"{tup}.res_conv1", *fup, "res_conv1")
            _convert_cbr(cv, f"{tup}.res_conv2", *fup, "res_conv2")
            if cv.probe(f"{tup}.skip1.conv.weight", *fup, "skip1"):
                _convert_cbr(cv, f"{tup}.skip1", *fup, "skip1")
                _convert_cbr(cv, f"{tup}.skip2", *fup, "skip2")
            if cv.probe(f"{tup}.cross_conv.conv.weight", *fup, "cross_conv"):
                _convert_cbr(cv, f"{tup}.cross_conv", *fup, "cross_conv")
            if prm and cv.probe(f"{tup}.prm.conv_bn_relu_prm_1.conv.weight",
                                *fup, "prm"):
                for tn, fn in _PRM_NAMES.items():
                    _convert_cbr(cv, f"{tup}.prm.{tn}", *fup, "prm", fn)


def rsn_family(cfg):
    """The family arguments of :func:`_map_rsn` from a config
    (``torch_convert.py:459-464`` there)."""
    extra = cfg.MODEL.EXTRA
    return dict(stage_num=extra.get("STAGE_NUM", 1),
                layers=tuple(extra.get("LAYERS", (2, 2, 2, 2))),
                plain=extra.get("PLAIN_BOTTLENECK", False),
                se=extra.get("USE_SE", False),
                prm=extra.get("USE_PRM", False))


# ------------------------------------------------------------ mobile nets
MOBILE_NAMES = {
    f"{base}{head}" for base in ("pose_shufflenetv2_plus",
                                 "pose_shufflenetv2_10x",
                                 "pose_mobilenetv3_small")
    for head in ("", "_pixel_shuffle")} | {
    "shufflenetv2_test", "pose_mobilevit_pixel_shuffle",
    "pose_mobilevitv2_pixel_shuffle"}


def _convert_se_hardsigmoid(cv, tprefix, *path):
    """ShuffleNetV2+'s SELayer (``SE_opr``: [1] conv, [2] bn, [4] conv)."""
    cv.conv(f"{tprefix}.SE_opr.1", *path, "fc1")
    cv.bn(f"{tprefix}.SE_opr.2", *path, "bn")
    cv.conv(f"{tprefix}.SE_opr.4", *path, "fc2")


def _convert_shuffle_block(cv, tp, fp, xception):
    """One ShuffleV2Block / Shufflenet / Shuffle_Xception."""
    if xception:
        pairs = [("0", "dw1"), ("2", "pw1"), ("5", "dw2"), ("7", "pw2"),
                 ("10", "dw3"), ("12", "pw3")]
        se_idx = 15
    else:
        pairs = [("0", "pw"), ("3", "dw"), ("5", "pwl")]
        se_idx = 8
    for ti, fn in pairs:
        cv.conv(f"{tp}.branch_main.{ti}", *fp, fn, "conv")
        cv.bn(f"{tp}.branch_main.{int(ti) + 1}", *fp, fn, "bn")
    if cv.probe(f"{tp}.branch_main.{se_idx}.SE_opr.1.weight", *fp, "se"):
        _convert_se_hardsigmoid(cv, f"{tp}.branch_main.{se_idx}", *fp, "se")
    if cv.probe(f"{tp}.branch_proj.0.weight", *fp, "proj_dw"):
        cv.conv(f"{tp}.branch_proj.0", *fp, "proj_dw", "conv")
        cv.bn(f"{tp}.branch_proj.1", *fp, "proj_dw", "bn")
        cv.conv(f"{tp}.branch_proj.2", *fp, "proj_pw", "conv")
        cv.bn(f"{tp}.branch_proj.3", *fp, "proj_pw", "bn")


def _map_shufflenetv2(cv, prefix, fr, n_blocks, arch=None):
    """ShuffleNetV2 (``arch`` None) or ShuffleNetV2+ (``arch`` the block
    types, 3 = Xception)."""
    cv.conv(f"{prefix}first_conv.0", *fr, "first_conv", "conv")
    cv.bn(f"{prefix}first_conv.1", *fr, "first_conv", "bn")
    for i in range(n_blocks):
        _convert_shuffle_block(cv, f"{prefix}features.{i}",
                               (*fr, f"block{i}"),
                               arch is not None and arch[i] == 3)
    cv.conv(f"{prefix}conv_last.0", *fr, "conv_last", "conv")
    cv.bn(f"{prefix}conv_last.1", *fr, "conv_last", "bn")


def _convert_cna(cv, tkey, *path):
    """corenet ConvLayer (``.block.conv`` [+ ``.block.norm``]) →
    ``ConvNormAct``."""
    cv.conv(f"{tkey}.block.conv", *path, "conv")
    if cv.probe(f"{tkey}.block.norm.weight", *path, "bn"):
        cv.bn(f"{tkey}.block.norm", *path, "bn")


def _convert_corenet_mv2(cv, tp, fp):
    """corenet InvertedResidual (backbones/mobilevit.py:239-366)."""
    if cv.probe(f"{tp}.block.exp_1x1.block.conv.weight", *fp, "exp_1x1"):
        _convert_cna(cv, f"{tp}.block.exp_1x1", *fp, "exp_1x1")
    _convert_cna(cv, f"{tp}.block.conv_3x3", *fp, "conv_3x3")
    _convert_cna(cv, f"{tp}.block.red_1x1", *fp, "red_1x1")


# transformer depth of each MobileViT stage (MOBILEVIT_SPEC's L)
_MOBILEVIT_DEPTHS = (2, 4, 3)


def _map_mobilevit(cv, prefix, fr):
    p = prefix
    _convert_cna(cv, f"{p}conv_1", *fr, "conv_1")
    _convert_corenet_mv2(cv, f"{p}layer_1.0", (*fr, "layer1_0"))
    for i in range(3):
        _convert_corenet_mv2(cv, f"{p}layer_2.{i}", (*fr, f"layer2_{i}"))
    for li, L in zip((3, 4, 5), _MOBILEVIT_DEPTHS):
        _convert_corenet_mv2(cv, f"{p}layer_{li}.0", (*fr, f"layer{li}_mv2"))
        tp, fp = f"{p}layer_{li}.1", (*fr, f"layer{li}_vit")
        _convert_cna(cv, f"{tp}.local_rep.conv_3x3", *fp, "local_3x3")
        cv.conv(f"{tp}.local_rep.conv_1x1.block.conv", *fp, "local_1x1")
        for b in range(L):
            base, tr = f"{tp}.global_rep.{b}", (*fp, f"tr{b}")
            cv.ln(f"{base}.pre_norm_mha.0", *tr, "ln1")
            cv.mha(f"{base}.pre_norm_mha.1", *tr, "attn")
            cv.ln(f"{base}.pre_norm_ffn.0", *tr, "ln2")
            cv.dense(f"{base}.pre_norm_ffn.1", *tr, "fc1")
            cv.dense(f"{base}.pre_norm_ffn.4", *tr, "fc2")
        cv.ln(f"{tp}.global_rep.{L}", *fp, "ln_out")
        _convert_cna(cv, f"{tp}.conv_proj", *fp, "conv_proj")
        _convert_cna(cv, f"{tp}.fusion", *fp, "fusion")
    _convert_cna(cv, f"{p}conv_1x1_exp", *fr, "conv_1x1_exp")


def _map_mobilevitv2(cv, prefix, fr):
    p = prefix
    _convert_cna(cv, f"{p}conv_1", *fr, "conv_1")
    _convert_corenet_mv2(cv, f"{p}layer_1.0", (*fr, "layer1_0"))
    for i in range(2):
        _convert_corenet_mv2(cv, f"{p}layer_2.{i}", (*fr, f"layer2_{i}"))
    for li, L in zip((3, 4, 5), (2, 4, 3)):
        _convert_corenet_mv2(cv, f"{p}layer_{li}.0", (*fr, f"layer{li}_mv2"))
        tp, fp = f"{p}layer_{li}.1", (*fr, f"layer{li}_vit")
        _convert_cna(cv, f"{tp}.local_rep.0", *fp, "local_dw")
        cv.conv(f"{tp}.local_rep.1.block.conv", *fp, "local_1x1")
        for b in range(L):
            base, ab = f"{tp}.global_rep.{b}", (*fp, f"attn{b}")
            cv.ln(f"{base}.pre_norm_attn.0", *ab, "norm1")
            cv.conv(f"{base}.pre_norm_attn.1.qkv_proj.block.conv",
                    *ab, "attn", "qkv_proj")
            cv.conv(f"{base}.pre_norm_attn.1.out_proj.block.conv",
                    *ab, "attn", "out_proj")
            cv.ln(f"{base}.pre_norm_ffn.0", *ab, "norm2")
            cv.conv(f"{base}.pre_norm_ffn.1.block.conv", *ab, "ffn1")
            cv.conv(f"{base}.pre_norm_ffn.3.block.conv", *ab, "ffn2")
        cv.ln(f"{tp}.global_rep.{L}", *fp, "norm_out")
        _convert_cna(cv, f"{tp}.conv_proj", *fp, "conv_proj")


def _map_mobilenetv3_small(cv, prefix, fr):
    """torchvision ``mobilenet_v3_small`` features under ``prefix``."""
    from ..models.mobile import MOBILENETV3_SMALL_SPEC

    def cna(tkey, *path):
        cv.conv(f"{tkey}.0", *path, "conv")
        cv.bn(f"{tkey}.1", *path, "bn")

    cna(f"{prefix}0", *fr, "stem")
    in_ch = 16
    for bi, (exp, out, _k, _s, se, _act) in enumerate(MOBILENETV3_SMALL_SPEC):
        tb, j = f"{prefix}{bi + 1}.block", 0
        if exp != in_ch:
            cna(f"{tb}.{j}", *fr, f"b{bi}_expand")
            j += 1
        cna(f"{tb}.{j}", *fr, f"b{bi}_dw")
        j += 1
        if se:
            cv.conv(f"{tb}.{j}.fc1", *fr, f"b{bi}_se", "fc1")
            cv.conv(f"{tb}.{j}.fc2", *fr, f"b{bi}_se", "fc2")
            j += 1
        cna(f"{tb}.{j}", *fr, f"b{bi}_project")
        in_ch = out
    cna(f"{prefix}12", *fr, "conv_last")


def mobile_family_from_cfg(cfg):
    """What :func:`_map_pose_mobile` needs of a mobile pose config: (the
    backbone: ``shufflenetv2_plus`` | ``shufflenetv2_10x`` |
    ``mobilenetv3_small`` | ``mobilevit`` | ``mobilevitv2``, the head:
    ``deconv`` | ``pixel_shuffle``, the number of DUCs)."""
    name = cfg.MODEL.NAME
    if name not in MOBILE_NAMES:
        raise KeyError(f"not a mobile pose model: {name!r}")
    if name == "shufflenetv2_test":
        return "shufflenetv2_10x", "pixel_shuffle", 3
    backbone = next(b for b in ("shufflenetv2_plus", "shufflenetv2_10x",
                                "mobilenetv3_small", "mobilevitv2",
                                "mobilevit") if b in name)
    if "pixel_shuffle" in name:
        arch = cfg.MODEL.EXTRA.get("ARCHITECTURE", (512, 256, 128))
        return backbone, "pixel_shuffle", len(arch)
    return backbone, "deconv", 0


def mobile_family(model):
    """:func:`mobile_family_from_cfg` of a built ``MobilePoseNet``."""
    from ..models.mobile import (MobileNetV3Small, ShuffleNetV2,
                                 ShuffleNetV2Plus)
    from ..models.mobilevit import MobileViT, MobileViTv2
    backbone = {ShuffleNetV2Plus: "shufflenetv2_plus",
                ShuffleNetV2: "shufflenetv2_10x",
                MobileNetV3Small: "mobilenetv3_small", MobileViT: "mobilevit",
                MobileViTv2: "mobilevitv2"}[type(model.backbone)]
    if model.head == "pixel_shuffle":
        return backbone, "pixel_shuffle", len(model.decoder.duc)
    return backbone, "deconv", 0


def _map_pose_mobile(cv, family):
    """The mobile pose wrapper (``backbone.`` + ``deconv_layers.`` or
    ``decoder.`` + ``final_layer``) against the JAX package's
    ``MobilePoseNet``; ``family`` from :func:`mobile_family_from_cfg`."""
    from ..models.mobile import SHUFFLENETV2_PLUS_ARCH
    backbone, head, n_duc = family
    tp, fr = "backbone.", ("backbone",)
    if backbone == "shufflenetv2_plus":
        _map_shufflenetv2(cv, tp, fr, 20, SHUFFLENETV2_PLUS_ARCH)
    elif backbone == "shufflenetv2_10x":
        _map_shufflenetv2(cv, tp, fr, 16)
    elif backbone == "mobilenetv3_small":
        # the reference wraps Sequential(features): "backbone.0.<idx>"
        _map_mobilenetv3_small(cv, f"{tp}0.", fr)
    elif backbone == "mobilevitv2":
        _map_mobilevitv2(cv, tp, fr)
    else:
        _map_mobilevit(cv, tp, fr)
    if head == "pixel_shuffle":
        cv.conv("decoder.conv_compress", "decoder", "conv_compress")
        for i in range(n_duc):
            cv.conv(f"decoder.duc.{i}.conv", "decoder", f"duc{i}", "cb",
                    "conv")
            cv.bn(f"decoder.duc.{i}.bn", "decoder", f"duc{i}", "cb", "bn")
    else:
        i = di = 0
        while cv.probe(f"deconv_layers.{i}.weight", "deconv", f"deconv{di}"):
            cv.conv(f"deconv_layers.{i}", "deconv", f"deconv{di}",
                    transposed=True)
            cv.bn(f"deconv_layers.{i + 1}", "deconv", f"bn{di}")
            i += 3
            di += 1
    cv.conv("final_layer", "final_layer")


class _SiteRecorder(Converter):
    """Walks a family mapping over a port model's own state-dict keys and
    records, for each conv, its module name → the flax module path the
    JAX package gives the same conv (``quantize._path_of``)."""

    def __init__(self, model):
        self.keys = set(model.state_dict())
        self.sites: Dict[str, str] = {}

    def probe(self, tkey: str, *fpath) -> bool:
        return tkey in self.keys

    def conv(self, tkey: str, *path, transposed=False):
        # a transposed conv is no int8 site in either package
        if not transposed:
            self.sites[tkey] = "/".join(path)

    def bn(self, tkey: str, *path):
        pass

    def dense(self, tkey: str, *path):
        pass

    def ln(self, tkey: str, *path, tshape=None):
        pass

    def mha(self, tkey: str, *path):
        pass


def conv_sites(model) -> Dict[str, str]:
    """{port conv module name: flax path} of a ported model (HRNet,
    SimpleBaseline, either with PSA, RSN, the mobile nets or YOLOv5), e.g.
    ``stage2.0.branches.0.0.conv1`` → ``stage2_0/branch0_0/cb1/conv``,
    ``layer1.0.conv1`` → ``backbone/layer1_0/cb1/conv``,
    ``stage0.upsample.up1.u_skip.conv`` → ``stage0_up/up1/u_skip/conv``
    and ``model.24.m.0`` → ``detect0``: the names under which a
    calibration table keys its conv sites, in either package."""
    from ..models.hrnet import PoseHRNet
    from ..models.pose_mobile import MobilePoseNet
    from ..models.resnet import PoseResNet
    from ..models.rsn import RSN
    from ..models.yolov5 import YOLOv5
    rec = _SiteRecorder(model)
    if isinstance(model, PoseHRNet):
        _map_pose_hrnet(rec, model.stages_cfg, model.psa)
    elif isinstance(model, PoseResNet):
        _map_pose_resnet(rec, model.num_layers, model.psa)
    elif isinstance(model, RSN):
        _map_rsn(rec, model.stage_num, model.layers, model.plain, model.se,
                 model.use_prm)
    elif isinstance(model, YOLOv5):
        _map_yolov5(rec)
    elif isinstance(model, MobilePoseNet):
        _map_pose_mobile(rec, mobile_family(model))
    else:
        raise KeyError(f"no conv-site map for {type(model).__name__}; "
                       "mapped: PoseHRNet, PoseResNet, RSN, MobilePoseNet, "
                       "YOLOv5")
    return rec.sites


def variables_to_state_dict(variables, cfg) -> Dict[str, np.ndarray]:
    """JAX-package variables of ``cfg``'s model → the port's state_dict
    (numpy values; ``model.load_state_dict(strict=True)`` accepts it)."""
    from ..models.hrnet import stages_from_cfg
    name = cfg.MODEL.NAME
    cv = Converter(variables)
    if name in ("pose_hrnet", "pose_hrnet_psa"):
        _map_pose_hrnet(cv, stages_from_cfg(cfg), psa=name.endswith("_psa"))
    elif name in ("pose_resnet", "pose_resnet_psa"):
        _map_pose_resnet(cv, cfg.MODEL.EXTRA.NUM_LAYERS,
                         psa=name.endswith("_psa"))
    elif name == "rsn":
        _map_rsn(cv, **rsn_family(cfg))
    elif name in MOBILE_NAMES:
        _map_pose_mobile(cv, mobile_family_from_cfg(cfg))
    else:
        raise KeyError(f"no weight mapping for model {name!r}; ported: "
                       "['pose_hrnet', 'pose_hrnet_psa', 'pose_resnet', "
                       f"'pose_resnet_psa', 'rsn'] and {sorted(MOBILE_NAMES)}")
    return cv.sd


# ultralytics yolov5 v6.0 module indices → the JAX package's layer names
_YOLO_LAYERS = [
    ("0", "b0", "conv"), ("1", "b1", "conv"), ("2", "b2", "c3"),
    ("3", "b3", "conv"), ("4", "b4", "c3"), ("5", "b5", "conv"),
    ("6", "b6", "c3"), ("7", "b7", "conv"), ("8", "b8", "c3"),
    ("9", "b9", "sppf"), ("10", "h10", "conv"), ("13", "h13", "c3"),
    ("14", "h14", "conv"), ("17", "h17", "c3"), ("18", "h18", "conv"),
    ("20", "h20", "c3"), ("21", "h21", "conv"), ("23", "h23", "c3"),
]


def _map_yolov5(cv: Converter, prefix="model."):
    def conv_unit(tp, *path):
        cv.conv(f"{tp}.conv", *path, "conv")
        cv.bn(f"{tp}.bn", *path, "bn")

    for idx, name, kind in _YOLO_LAYERS:
        tp = prefix + idx
        if kind == "conv":
            conv_unit(tp, name)
        elif kind == "sppf":
            conv_unit(f"{tp}.cv1", name, "cv1")
            conv_unit(f"{tp}.cv2", name, "cv2")
        else:
            for cvname in ("cv1", "cv2", "cv3"):
                conv_unit(f"{tp}.{cvname}", name, cvname)
            j = 0
            while cv.probe(f"{tp}.m.{j}.cv1.conv.weight", name, f"m{j}"):
                conv_unit(f"{tp}.m.{j}.cv1", name, f"m{j}", "cv1")
                conv_unit(f"{tp}.m.{j}.cv2", name, f"m{j}", "cv2")
                j += 1
    for li in range(3):
        cv.conv(f"{prefix}24.m.{li}", f"detect{li}")


def yolov5_variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """The JAX package's flax YOLOv5 variables (numpy) → the port's
    YOLOv5 state dict, which is the ultralytics v6.0 layout
    (``model.{i}...``)."""
    cv = Converter(variables)
    _map_yolov5(cv)
    return cv.sd


def ultralytics_state_dict(sd) -> Dict[str, np.ndarray]:
    """An ultralytics YOLOv5 state dict (``torch.save(model.state_dict())``
    of a ``yolov5*.pt`` model, whose keys carry one ``model.`` prefix, or
    two from an ``attempt_load`` wrapper) → the port's keys: exactly one
    ``model.`` prefix, the ``anchor*`` buffers dropped."""
    out = {}
    for k, v in sd.items():
        while k.startswith("model."):
            k = k[len("model."):]
        if "anchor" in k:
            continue
        out["model." + k] = v if torch.is_tensor(v) else np.asarray(v)
    return out


def load_yolov5_weights(weights) -> Dict[str, object]:
    """YOLOv5 weights in any of the forms the engines take → the port's
    state dict: the JAX package's variables (a dict with ``params``), a
    state dict (the port's or ultralytics'), or a ``.pt`` / ``.pth`` path
    to a saved ultralytics state dict."""
    if isinstance(weights, (str, os.PathLike)):
        if not str(weights).endswith((".pt", ".pth")):
            raise ValueError(f"detector weights {weights!r}: a .pt or .pth "
                             "file holding a state dict")
        weights = torch.load(weights, map_location="cpu", weights_only=True)
    if "params" in weights:
        return yolov5_variables_to_state_dict(weights)
    return ultralytics_state_dict(weights)


def state_dict_to_torch(sd) -> Dict[str, torch.Tensor]:
    """{name: numpy array | tensor} → {name: tensor} for load_state_dict."""
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            for k, v in sd.items()}
