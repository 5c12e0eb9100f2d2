"""Per-family ONNX graph emitters for the pose-model zoo (a copy of
``udp_pose_tpu/export/onnx_families.py``).

Each emitter walks the architecture the port's model implements (the
reference torch model's) and emits an opset-11 NCHW graph whose
initializers are the model's state dict, which holds the reference torch
keys: the graph is the artifact the reference's own torch→ONNX export
would produce (deep_hrnet/tools/export.py:21-56; RSN network.py
topologies), and the bytes are the JAX package's exporter's for the same
state dict.  :func:`.onnx_eval.check_model` holds the graph against the
model's forward.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .onnx_build import GraphBuilder

# torch _get_deconv_cfg (pose_resnet.py:156-166): kernel → (pad, out_pad)
_DECONV_GEOM = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


def deconv_head(g: GraphBuilder, x: str, prefix: str = "deconv_layers"):
    """SimpleBaseline ConvTranspose-BN-ReLU chain (pose_resnet.py:168-193);
    returns (out, ×2-upsample count)."""
    i = n = 0
    while f"{prefix}.{i}.weight" in g.sd:
        k = int(g.sd[f"{prefix}.{i}.weight"].shape[2])
        pad, out_pad = _DECONV_GEOM[k]
        x = g.conv_transpose(x, f"{prefix}.{i}", stride=2, pad=pad)
        if out_pad:
            g.nodes[-1].attrs["output_padding"] = [out_pad, out_pad]
        x = g.relu(g.bn(x, f"{prefix}.{i + 1}"))
        i += 3
        n += 1
    return x, n


def _layernorm_c11(g: GraphBuilder, x: str, tp: str,
                   eps: float = 1e-5) -> str:
    """torch LayerNorm([C,1,1]) on a (B,C,1,1) tensor, decomposed
    (opset 11 has no LayerNormalization op)."""
    mu = g.node("ReduceMean", [x], axes=[1, 2, 3], keepdims=1)
    d = g.node("Sub", [x, mu])
    var = g.node("ReduceMean", [g.mul(d, d)], axes=[1, 2, 3], keepdims=1)
    eps_c = g.const(f"ln_eps_{eps:g}", np.asarray([eps], np.float32))
    denom = g.node("Sqrt", [g.add(var, eps_c)])
    y = g.node("Div", [d, denom])
    y = g.mul(y, g.weight(f"{tp}.weight"))
    return g.add(y, g.weight(f"{tp}.bias"))


def _psa_s(g: GraphBuilder, x: str, tp: str, hw) -> str:
    """PSA_s (PSA.py:146-269): channel gate then spatial gate.  ``hw`` is
    the static feature size (needed to reshape attention maps back)."""
    h, w = hw
    inter = int(g.sd[f"{tp}.conv_v_right.weight"].shape[0])
    # channel branch ("spatial_pool")
    v = g.conv(x, f"{tp}.conv_v_right", pad=0)
    q = g.conv(x, f"{tp}.conv_q_right", pad=0)
    q2 = g.reshape(q, (0, 1, -1))                       # B,1,HW
    attn = g.node("Softmax", [q2], axis=2)              # over HW (tail)
    v2 = g.reshape(v, (0, inter, -1))                   # B,inter,HW
    attn_t = g.transpose(attn, (0, 2, 1))               # B,HW,1
    ctx = g.node("MatMul", [v2, attn_t])                # B,inter,1
    ctx = g.reshape(ctx, (0, inter, 1, 1))
    ctx = g.conv(ctx, f"{tp}.conv_up.0", pad=0)
    ctx = _layernorm_c11(g, ctx, f"{tp}.conv_up.1")
    ctx = g.relu(ctx)
    ctx = g.conv(ctx, f"{tp}.conv_up.3", pad=0)
    x = g.mul(x, g.sigmoid(ctx))
    # spatial branch ("channel_pool")
    gq = g.conv(x, f"{tp}.conv_q_left", pad=0)
    avg = g.global_avgpool(gq)
    avg = g.reshape(avg, (0, inter, 1))                 # B,inter,1
    theta = g.conv(x, f"{tp}.conv_v_left", pad=0)
    theta = g.reshape(theta, (0, inter, -1))
    theta = g.transpose(theta, (0, 2, 1))               # B,HW,inter
    theta = g.node("Softmax", [theta], axis=2)          # over inter (tail)
    sp = g.node("MatMul", [theta, avg])                 # B,HW,1
    sp = g.transpose(sp, (0, 2, 1))
    sp = g.reshape(sp, (0, 1, h, w))
    return g.mul(x, g.sigmoid(sp))


def _basic_block(g: GraphBuilder, x: str, tp: str, stride: int,
                 hw=None) -> str:
    """BasicBlock (pose_hrnet.py:29-59); PSA insert between conv1 and
    conv2 when the block has deattn weights (pose_hrnet_psa.py:37,:49)."""
    out = g.conv_bn_relu(x, f"{tp}.conv1", f"{tp}.bn1", stride=stride)
    if f"{tp}.deattn.conv_q_right.weight" in g.sd:
        out = _psa_s(g, out, f"{tp}.deattn", hw)
    out = g.conv(out, f"{tp}.conv2")
    out = g.bn(out, f"{tp}.bn2")
    res = x
    if f"{tp}.downsample.0.weight" in g.sd:
        res = g.conv(x, f"{tp}.downsample.0", stride=stride, pad=0)
        res = g.bn(res, f"{tp}.downsample.1")
    return g.relu(g.add(out, res))


def _bottleneck(g: GraphBuilder, x: str, tp: str, stride: int) -> str:
    """Bottleneck (pose_hrnet.py:62-101)."""
    out = g.conv_bn_relu(x, f"{tp}.conv1", f"{tp}.bn1")
    out = g.conv_bn_relu(out, f"{tp}.conv2", f"{tp}.bn2", stride=stride)
    out = g.conv(out, f"{tp}.conv3")
    out = g.bn(out, f"{tp}.bn3")
    res = x
    if f"{tp}.downsample.0.weight" in g.sd:
        res = g.conv(x, f"{tp}.downsample.0", stride=stride, pad=0)
        res = g.bn(res, f"{tp}.downsample.1")
    return g.relu(g.add(out, res))


def build_pose_resnet(sd: Dict[str, np.ndarray], num_layers: int,
                      num_joints: int, target_type: str,
                      image_size: Sequence[int],
                      final_conv_kernel: int = 1,
                      batch: int = 1) -> bytes:
    """pose_resnet → ONNX (reference lib/models/pose_resnet.py)."""
    from ..models.resnet import RESNET_SPEC
    _block, layers = RESNET_SPEC[num_layers]
    bottleneck = num_layers >= 50
    w, h = int(image_size[0]), int(image_size[1])

    g = GraphBuilder(sd, f"pose_resnet_{num_layers}")
    x = g.conv("images", "conv1", stride=2, pad=3)
    x = g.relu(g.bn(x, "bn1"))
    x = g.maxpool(x)
    cur = (-(-h // 4), -(-w // 4))
    for li, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            if s == 2:
                cur = (-(-cur[0] // 2), -(-cur[1] // 2))
            if bottleneck:
                x = _bottleneck(g, x, f"layer{li + 1}.{bi}", s)
            else:
                x = _basic_block(g, x, f"layer{li + 1}.{bi}", s, hw=cur)
    x, _ = deconv_head(g, x)
    pad = 1 if final_conv_kernel == 3 else 0
    x = g.conv(x, "final_layer", pad=pad, out="output")

    out_ch = num_joints * 3 if target_type == "offset" else num_joints
    return g.finish("images", (batch, 3, h, w), "output",
                    (batch, out_ch, h // 4, w // 4),
                    doc=f"pose_resnet_{num_layers} {w}x{h}")


def build_pose_hrnet(sd: Dict[str, np.ndarray], stages_cfg,
                     num_joints: int, target_type: str,
                     image_size: Sequence[int],
                     final_conv_kernel: int = 1,
                     batch: int = 1) -> bytes:
    """pose_hrnet → ONNX (reference lib/models/pose_hrnet.py; same walk
    as models/hrnet.PoseHRNet incl. the last-module ×4 widening)."""
    w, h = int(image_size[0]), int(image_size[1])
    expansion = {"BASIC": 1, "BOTTLENECK": 4}

    g = GraphBuilder(sd, "pose_hrnet")
    x = g.conv_bn_relu("images", "conv1", "bn1", stride=2)
    x = g.conv_bn_relu(x, "conv2", "bn2", stride=2)
    for bi in range(4):
        x = _bottleneck(g, x, f"layer1.{bi}", 1)
    xs = [x]
    prev_ch = [256]

    for si, (num_modules, nb, block, num_blocks, num_channels) in \
            enumerate(stages_cfg):
        t = si + 1
        exp = expansion[block]
        width = [c * exp for c in num_channels]
        # transition (pose_hrnet.py:346-386)
        new_xs = []
        for i in range(nb):
            if i < len(prev_ch):
                if f"transition{t}.{i}.0.weight" in g.sd:
                    y = g.conv_bn_relu(xs[i], f"transition{t}.{i}.0",
                                       f"transition{t}.{i}.1")
                else:
                    y = xs[i]
            else:
                y = xs[-1]
                for j in range(i + 1 - len(prev_ch)):
                    y = g.conv_bn_relu(y, f"transition{t}.{i}.{j}.0",
                                       f"transition{t}.{i}.{j}.1", stride=2)
            new_xs.append(y)
        xs = new_xs
        last_stage = si == len(stages_cfg) - 1
        for mi in range(num_modules):
            mso = not (last_stage and mi == num_modules - 1)
            tmod = f"stage{si + 2}.{mi}"
            outs = []
            for br in range(nb):
                y = xs[br]
                br_hw = (h // 4 >> br, w // 4 >> br)
                for bi in range(num_blocks[br]):
                    tp = f"{tmod}.branches.{br}.{bi}"
                    y = (_basic_block(g, y, tp, 1, hw=br_hw)
                         if block == "BASIC" else _bottleneck(g, y, tp, 1))
                outs.append(y)
            n_out = nb if mso else 1
            fused = []
            for i in range(n_out):
                acc = None
                for j in range(nb):
                    base = f"{tmod}.fuse_layers.{i}.{j}"
                    if j > i:
                        y = g.conv(outs[j], f"{base}.0", pad=0)
                        y = g.bn(y, f"{base}.1")
                        y = g.upsample(y, 2 ** (j - i), mode="nearest")
                    elif j == i:
                        if f"{base}.0.weight" in g.sd:
                            # last-module widening 1x1, no BN
                            y = g.conv(outs[j], f"{base}.0", pad=0)
                        else:
                            y = outs[j]
                    else:
                        y = outs[j]
                        for k in range(i - j):
                            y = g.conv(y, f"{base}.{k}.0", stride=2)
                            y = g.bn(y, f"{base}.{k}.1")
                            if k != i - j - 1:
                                y = g.relu(y)
                    acc = y if acc is None else g.add(acc, y)
                fused.append(g.relu(acc))
            xs = fused if mso else fused + xs[1:]
        prev_ch = list(width)

    pad = 1 if final_conv_kernel == 3 else 0
    x = g.conv(xs[0], "final_layer", pad=pad, out="output")
    out_ch = num_joints * 3 if target_type == "offset" else num_joints
    return g.finish("images", (batch, 3, h, w), "output",
                    (batch, out_ch, h // 4, w // 4),
                    doc=f"pose_hrnet {w}x{h}")


def numpy_state_dict(model_or_state_dict) -> Dict[str, np.ndarray]:
    """A port model's state dict, or a state dict of tensors or arrays,
    as float32 numpy arrays on the host (integer buffers such as
    BatchNorm's ``num_batches_tracked`` keep their type)."""
    sd = (model_or_state_dict.state_dict()
          if hasattr(model_or_state_dict, "state_dict")
          else model_or_state_dict)
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach()
            v = (v.float() if v.is_floating_point() else v).cpu().numpy()
        v = np.asarray(v)
        out[k] = v.astype(np.float32) if v.dtype.kind == "f" else v
    return out


def export_onnx_from_cfg(model_or_state_dict, cfg, batch: int = 1) -> bytes:
    """A port model of ``cfg`` (or its state dict, tensors or numpy) →
    serialized ONNX ModelProto with a fixed ``batch``."""
    name = cfg.MODEL.NAME
    extra = cfg.MODEL.EXTRA
    sd = numpy_state_dict(model_or_state_dict)
    if name in ("pose_resnet", "pose_resnet_psa"):
        return build_pose_resnet(
            sd, extra.NUM_LAYERS, cfg.MODEL.NUM_JOINTS,
            cfg.MODEL.TARGET_TYPE, cfg.MODEL.IMAGE_SIZE,
            final_conv_kernel=extra.FINAL_CONV_KERNEL, batch=batch)
    if name in ("pose_hrnet", "pose_hrnet_psa"):
        from ..models.hrnet import stages_from_cfg
        return build_pose_hrnet(
            sd, stages_from_cfg(cfg), cfg.MODEL.NUM_JOINTS, cfg.MODEL.TARGET_TYPE,
            cfg.MODEL.IMAGE_SIZE,
            final_conv_kernel=extra.FINAL_CONV_KERNEL, batch=batch)
    if name == "rsn":
        from .onnx_rsn import build_rsn
        return build_rsn(sd, cfg, batch=batch)
    if name.startswith(("pose_shufflenetv2", "pose_mobilenetv3",
                        "pose_mobilevit")):
        from .onnx_mobile import build_pose_mobile
        return build_pose_mobile(sd, cfg, batch=batch)
    raise KeyError(f"no ONNX emitter for model {name!r} (supported: "
                   "pose_resnet[_psa], pose_hrnet[_psa], rsn, and the "
                   "mobile zoo)")
