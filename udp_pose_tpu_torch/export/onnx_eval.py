"""Evaluator for exported ONNX graphs, on the card or the CPU.

Port of ``udp_pose_tpu/export/onnx_eval.py``, which is written in torch
already: the serialized bytes are parsed back (:func:`.onnx_pb.
load_model`) and each node runs as torch functional ops with the opset-11
semantics of the public ONNX operator spec.  It mirrors the reference's
export check (deep_hrnet/tools/export.py:45-56: an onnxruntime run
and ``assert_allclose`` against torch) with the runtime swapped for this
evaluator.  Here it takes ``device=`` (default ``"cuda"``): a loaded
model's float initializers are uploaded once and kept with it; its
integer ones, and the constants that fix shapes (Reshape, Slice, Resize
scales, Clip bounds), stay on the host, so a run does not wait for the
card until its outputs are read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.platform import resolve_device
from .onnx_pb import ModelP, NodeP, load_model


def _as_model(model_or_bytes) -> ModelP:
    return (load_model(model_or_bytes)
            if isinstance(model_or_bytes, (bytes, bytearray))
            else model_or_bytes)


def initializers_on(model: ModelP, device: torch.device):
    """{name: tensor} of the model's initializers on ``device``, made
    once per loaded model and device (the float ones uploaded; the others
    kept on the host)."""
    cache = model.__dict__.setdefault("_initializers", {})
    key = str(device)
    if key not in cache:
        env = {}
        for init in model.graph.initializers:
            t = torch.from_numpy(np.ascontiguousarray(init.array))
            env[init.name] = (t.to(device) if t.is_floating_point() else t)
        cache[key] = env
    return cache[key]


def run_graph(model_or_bytes, inputs: Dict[str, object],
              device="cuda") -> Dict[str, torch.Tensor]:
    """Execute a loaded (or serialized) ONNX model on ``device``: inputs
    are float32 numpy arrays or tensors; returns {output name: tensor on
    ``device``}."""
    device = resolve_device(device)
    model = _as_model(model_or_bytes)
    g = model.graph
    host = {init.name: init.array for init in g.initializers}
    env = dict(initializers_on(model, device))
    for name, _shape in g.inputs:
        if name not in inputs:
            if name in env:  # initializer doubling as input
                continue
            raise KeyError(f"missing graph input {name}")
        x = inputs[name]
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        env[name] = x.to(device=device, dtype=torch.float32)
    for node in g.nodes:
        _exec(node, env, host)
    return {name: env[name] for name, _ in g.outputs}


def run_model(model_or_bytes, inputs: Dict[str, np.ndarray],
              device="cuda") -> Dict[str, np.ndarray]:
    """Execute a serialized (or loaded) ONNX model on ``device``; returns
    {output_name: numpy array}."""
    return {name: t.cpu().numpy()
            for name, t in run_graph(model_or_bytes, inputs, device).items()}


def _pads4(node) -> Sequence[int]:
    p = node.attrs.get("pads", [0, 0, 0, 0])
    return [int(x) for x in p]


def _static(node, k, env, host):
    """Input ``k`` of ``node`` as a host numpy array: the initializer's
    own array where it is one, else the tensor read back."""
    name = node.inputs[k]
    return host[name] if name in host else env[name].cpu().numpy()


def _exec(node: NodeP, env, host):
    op = node.op_type
    i = [env[x] for x in node.inputs if x != ""]
    a = node.attrs
    if op == "Conv":
        t, l, b, r = _pads4(node)
        x = F.pad(i[0], (l, r, t, b)) if (t, l, b, r) != (0, 0, 0, 0) else i[0]
        y = F.conv2d(x, i[1], i[2] if len(i) > 2 else None,
                     stride=[int(s) for s in a.get("strides", [1, 1])],
                     dilation=[int(d) for d in a.get("dilations", [1, 1])],
                     groups=int(a.get("group", 1)))
    elif op == "ConvTranspose":
        t, l, b, r = _pads4(node)
        assert t == b and l == r, "asymmetric ConvTranspose pads unsupported"
        y = F.conv_transpose2d(
            i[0], i[1], i[2] if len(i) > 2 else None,
            stride=[int(s) for s in a.get("strides", [1, 1])],
            padding=[t, l],
            output_padding=[int(x) for x in a.get("output_padding", [0, 0])],
            groups=int(a.get("group", 1)))
    elif op == "BatchNormalization":
        x, scale, bias, mean, var = i[:5]
        y = F.batch_norm(x, mean, var, scale, bias, training=False,
                         eps=float(a.get("epsilon", 1e-5)))
    elif op == "Relu":
        y = F.relu(i[0])
    elif op == "Sigmoid":
        y = torch.sigmoid(i[0])
    elif op == "HardSigmoid":
        alpha = float(a.get("alpha", 0.2))
        beta = float(a.get("beta", 0.5))
        y = torch.clamp(alpha * i[0] + beta, 0.0, 1.0)
    elif op == "Clip":
        lo = (_static(node, 1, env, host).item() if len(i) > 1
              else float(a.get("min", -np.inf)))
        hi = (_static(node, 2, env, host).item() if len(i) > 2
              else float(a.get("max", np.inf)))
        y = torch.clamp(i[0], lo, hi)
    elif op == "Add":
        y = i[0] + i[1]
    elif op == "Sub":
        y = i[0] - i[1]
    elif op == "Mul":
        y = i[0] * i[1]
    elif op == "Div":
        y = i[0] / i[1]
    elif op == "Concat":
        y = torch.cat(i, dim=int(a["axis"]))
    elif op == "MaxPool":
        t, l, b, r = _pads4(node)
        x = F.pad(i[0], (l, r, t, b), value=-float("inf"))
        y = F.max_pool2d(x, [int(k) for k in a["kernel_shape"]],
                         stride=[int(s) for s in a.get("strides", [1, 1])])
    elif op == "AveragePool":
        t, l, b, r = _pads4(node)
        # ONNX default count_include_pad=0: pads are excluded from the
        # divisor, unlike zero-pad + avg_pool2d
        assert t == b and l == r, "asymmetric AveragePool pads unsupported"
        assert not int(a.get("count_include_pad", 0)), "unsupported"
        y = F.avg_pool2d(i[0], [int(k) for k in a["kernel_shape"]],
                         stride=[int(s) for s in a.get("strides", [1, 1])],
                         padding=[t, l], count_include_pad=False)
    elif op == "GlobalAveragePool":
        y = i[0].mean(dim=(2, 3), keepdim=True)
    elif op == "Resize":
        scales = _static(node, 2, env, host) if len(i) > 2 else None
        mode = a.get("mode", b"nearest")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        ctm = a.get("coordinate_transformation_mode", b"half_pixel")
        ctm = ctm.decode() if isinstance(ctm, bytes) else ctm
        sh, sw = float(scales[2]), float(scales[3])
        if mode == "nearest":
            assert ctm == "asymmetric", ctm
            y = F.interpolate(i[0], scale_factor=(sh, sw), mode="nearest")
        else:
            y = F.interpolate(i[0], scale_factor=(sh, sw), mode="bilinear",
                              align_corners=(ctm == "align_corners"))
    elif op == "Gemm":
        x = i[0]
        w = i[1].t() if int(a.get("transB", 0)) else i[1]
        y = x @ w
        if len(i) > 2:
            y = y + i[2]
    elif op == "MatMul":
        y = i[0] @ i[1]
    elif op == "Softmax":
        # opset-11 semantics: flatten to 2D at `axis`, softmax the tail
        ax = int(a.get("axis", 1))
        shp = i[0].shape
        y = F.softmax(i[0].reshape(int(np.prod(shp[:ax])), -1),
                      dim=1).reshape(shp)
    elif op == "Sqrt":
        y = torch.sqrt(i[0])
    elif op == "ReduceMean":
        y = i[0].mean(dim=[int(d) for d in a["axes"]],
                      keepdim=bool(a.get("keepdims", 1)))
    elif op == "ReduceSum":
        y = i[0].sum(dim=[int(d) for d in a["axes"]],
                     keepdim=bool(a.get("keepdims", 1)))
    elif op == "Slice":
        # opset 11: data, starts, ends, axes, steps (all tensors)
        starts = [int(v) for v in _static(node, 1, env, host).tolist()]
        ends = [int(v) for v in _static(node, 2, env, host).tolist()]
        axes = ([int(v) for v in _static(node, 3, env, host).tolist()]
                if len(i) > 3 else list(range(len(starts))))
        steps = ([int(v) for v in _static(node, 4, env, host).tolist()]
                 if len(i) > 4 else [1] * len(starts))
        y = i[0]
        for s, e, ax, st in zip(starts, ends, axes, steps):
            idx = torch.arange(s, min(e, y.shape[ax]), st, device=y.device)
            y = y.index_select(ax, idx)
    elif op == "DepthToSpace":
        mode = a.get("mode", b"DCR")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        assert mode == "CRD", mode   # == torch pixel_shuffle
        y = F.pixel_shuffle(i[0], int(a["blocksize"]))
    elif op == "Reshape":
        # 0 copies the input dim (allowzero=0), -1 infers
        dims = [int(d) for d in _static(node, 1, env, host).tolist()]
        dims = [i[0].shape[k] if d == 0 else d for k, d in enumerate(dims)]
        y = i[0].reshape(dims)
    elif op == "Transpose":
        y = i[0].permute([int(p) for p in a["perm"]])
    elif op == "Split":
        parts = torch.split(i[0], [int(s) for s in a["split"]],
                            dim=int(a["axis"]))
        for out_name, part in zip(node.outputs, parts):
            env[out_name] = part
        return
    elif op == "Identity":
        y = i[0]
    else:
        raise NotImplementedError(f"op {op}")
    env[node.outputs[0]] = y


@contextlib.contextmanager
def fp32_exact(device):
    """float32 convs and matrix products without TF32 on a card (cuDNN
    and cuBLAS), restored on exit; nothing on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def check_model(model_bytes, x_nchw, expected_nchw, rtol=1e-3, atol=1e-4,
                device="cuda") -> float:
    """Run on ``device`` in float32 (TF32 off on a card) + compare (the
    reference's assert_allclose pattern, export.py:56).  Returns the max
    abs error."""
    model = _as_model(model_bytes)
    in_name = model.graph.inputs[0][0]
    out_name = model.graph.outputs[0][0]
    with fp32_exact(resolve_device(device)):
        got = run_model(model, {in_name: x_nchw}, device)[out_name]
    expected_nchw = np.asarray(expected_nchw)
    np.testing.assert_allclose(got, expected_nchw, rtol=rtol, atol=atol)
    return float(np.abs(got - expected_nchw).max())
