"""ONNX GraphBuilder: opset-11 vision ops over a reference-format
torch state_dict, which is what the port's models hold (a copy of
``udp_pose_tpu/export/onnx_build.py``).

Initializers keep the reference torch key names (``conv1.weight``, …) so
exported graphs are directly comparable to the reference's own
torch→ONNX output (deep_hrnet/tools/export.py:21-56).  The graph
computes in NCHW, as the port's models do; equivalence is asserted
numerically by :func:`.onnx_eval.check_model` against their forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .onnx_pb import FLOAT, GraphP, NodeP, TensorP, dump_model


class GraphBuilder:
    def __init__(self, state_dict: Dict[str, np.ndarray], name: str):
        self.sd = {k: np.asarray(v) for k, v in state_dict.items()}
        self.name = name
        self.nodes: list[NodeP] = []
        self.inits: list[TensorP] = []
        self._init_names: set[str] = set()
        self._counter = 0

    # ------------------------------------------------------------ plumbing

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def weight(self, key: str, dtype=np.float32) -> str:
        """Materialise state-dict entry ``key`` as an initializer."""
        if key not in self._init_names:
            if key not in self.sd:
                raise KeyError(f"state dict has no {key!r}")
            arr = self.sd[key].astype(dtype)
            self.inits.append(TensorP(key, arr))
            self._init_names.add(key)
        return key

    def const(self, name: str, arr: np.ndarray) -> str:
        if name not in self._init_names:
            self.inits.append(TensorP(name, np.asarray(arr)))
            self._init_names.add(name)
        return name

    def node(self, op: str, inputs: Sequence[str], out: Optional[str] = None,
             **attrs) -> str:
        out = out or self.fresh(op.lower())
        self.nodes.append(NodeP(op, list(inputs), [out],
                                name=self.fresh(f"n_{op}"), attrs=attrs))
        return out

    # ------------------------------------------------------------ layers

    def conv(self, x: str, prefix: str, stride: int = 1,
             pad: Optional[int] = None, kernel: Optional[int] = None,
             group: int = 1, dilation: int = 1, out: Optional[str] = None) -> str:
        """Conv from ``{prefix}.weight`` (+ ``.bias`` when present)."""
        w = self.sd[f"{prefix}.weight"]
        k = int(w.shape[2]) if kernel is None else kernel
        if pad is None:
            pad = (k - 1) // 2 * dilation
        inputs = [x, self.weight(f"{prefix}.weight")]
        if f"{prefix}.bias" in self.sd:
            inputs.append(self.weight(f"{prefix}.bias"))
        return self.node(
            "Conv", inputs, out,
            dilations=[dilation, dilation], group=group,
            kernel_shape=[k, k], pads=[pad, pad, pad, pad],
            strides=[stride, stride])

    def conv_transpose(self, x: str, prefix: str, stride: int = 2,
                       pad: int = 1, out: Optional[str] = None) -> str:
        w = self.sd[f"{prefix}.weight"]
        k = int(w.shape[2])
        inputs = [x, self.weight(f"{prefix}.weight")]
        if f"{prefix}.bias" in self.sd:
            inputs.append(self.weight(f"{prefix}.bias"))
        return self.node(
            "ConvTranspose", inputs, out,
            dilations=[1, 1], group=1, kernel_shape=[k, k],
            pads=[pad, pad, pad, pad], strides=[stride, stride])

    def bn(self, x: str, prefix: str, eps: float = 1e-5,
           out: Optional[str] = None) -> str:
        return self.node(
            "BatchNormalization",
            [x, self.weight(f"{prefix}.weight"),
             self.weight(f"{prefix}.bias"),
             self.weight(f"{prefix}.running_mean"),
             self.weight(f"{prefix}.running_var")],
            out, epsilon=eps, momentum=0.9)

    def relu(self, x: str, out: Optional[str] = None) -> str:
        return self.node("Relu", [x], out)

    def sigmoid(self, x: str, out: Optional[str] = None) -> str:
        return self.node("Sigmoid", [x], out)

    def add(self, a: str, b: str, out: Optional[str] = None) -> str:
        return self.node("Add", [a, b], out)

    def mul(self, a: str, b: str, out: Optional[str] = None) -> str:
        return self.node("Mul", [a, b], out)

    def concat(self, xs: Sequence[str], axis: int = 1,
               out: Optional[str] = None) -> str:
        return self.node("Concat", list(xs), out, axis=axis)

    def maxpool(self, x: str, kernel: int = 3, stride: int = 2,
                pad: int = 1, out: Optional[str] = None) -> str:
        return self.node("MaxPool", [x], out,
                         kernel_shape=[kernel, kernel],
                         pads=[pad, pad, pad, pad],
                         strides=[stride, stride])

    def avgpool(self, x: str, kernel: int, stride: int,
                pad: int = 0, out: Optional[str] = None) -> str:
        return self.node("AveragePool", [x], out,
                         kernel_shape=[kernel, kernel],
                         pads=[pad, pad, pad, pad],
                         strides=[stride, stride])

    def global_avgpool(self, x: str, out: Optional[str] = None) -> str:
        return self.node("GlobalAveragePool", [x], out)

    def upsample(self, x: str, factor: int, mode: str = "nearest",
                 align_corners: bool = False,
                 out: Optional[str] = None) -> str:
        """Resize ×factor (opset 11: inputs X, roi, scales)."""
        roi = self.const("resize_roi_empty", np.zeros(0, np.float32))
        scales = self.const(
            f"resize_scales_{factor}",
            np.asarray([1.0, 1.0, float(factor), float(factor)], np.float32))
        if mode == "nearest":
            ctm = "asymmetric"
        else:
            ctm = "align_corners" if align_corners else "pytorch_half_pixel"
        return self.node(
            "Resize", [x, roi, scales], out,
            coordinate_transformation_mode=ctm, cubic_coeff_a=-0.75,
            mode=mode, nearest_mode="floor")

    def gemm(self, x: str, prefix: str, out: Optional[str] = None) -> str:
        """Gemm y = x·Wᵀ + b from a torch Linear ``{prefix}.weight``."""
        inputs = [x, self.weight(f"{prefix}.weight")]
        if f"{prefix}.bias" in self.sd:
            inputs.append(self.weight(f"{prefix}.bias"))
        return self.node("Gemm", inputs, out,
                         alpha=1.0, beta=1.0, transB=1)

    def reshape(self, x: str, shape: Sequence[int],
                out: Optional[str] = None) -> str:
        s = self.const(f"shape_{'x'.join(str(d) for d in shape)}",
                       np.asarray(shape, np.int64))
        return self.node("Reshape", [x, s], out)

    def transpose(self, x: str, perm: Sequence[int],
                  out: Optional[str] = None) -> str:
        return self.node("Transpose", [x], out, perm=list(perm))

    def split(self, x: str, sizes: Sequence[int], axis: int = 1):
        outs = [self.fresh("split") for _ in sizes]
        self.nodes.append(NodeP("Split", [x], outs,
                                name=self.fresh("n_Split"),
                                attrs={"axis": axis, "split": list(sizes)}))
        return outs

    def slice_axis(self, x: str, start: int, end: int, axis: int = 1,
                   step: int = 1, out: Optional[str] = None) -> str:
        """opset-11 Slice (tensor operands, supports strided steps)."""
        mk = lambda tag, v: self.const(  # noqa: E731
            f"slice_{tag}_{v}", np.asarray([v], np.int64))
        return self.node("Slice",
                         [x, mk("s", start), mk("e", end),
                          mk("a", axis), mk("st", step)], out)

    def depth_to_space(self, x: str, blocksize: int,
                       out: Optional[str] = None) -> str:
        """CRD mode == torch nn.PixelShuffle."""
        return self.node("DepthToSpace", [x], out,
                         blocksize=blocksize, mode="CRD")

    def conv_bn_relu(self, x: str, conv_key: str, bn_key: str,
                     stride: int = 1, relu: bool = True, group: int = 1,
                     pad: Optional[int] = None) -> str:
        x = self.conv(x, conv_key, stride=stride, group=group, pad=pad)
        x = self.bn(x, bn_key)
        return self.relu(x) if relu else x

    # ------------------------------------------------------------ assembly

    def finish(self, input_name: str, input_shape, output_name: str,
               output_shape, doc: str = "") -> bytes:
        graph = GraphP(self.name, self.nodes,
                       [(input_name, list(input_shape))],
                       [(output_name, list(output_shape))],
                       self.inits)
        return dump_model(graph, opset=11, doc=doc)
