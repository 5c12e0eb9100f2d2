"""Self-contained ONNX protobuf wire-format writer/reader (a copy of
``udp_pose_tpu/export/onnx_pb.py``; numpy only).

No ``onnx`` package is needed: this module serialises the ONNX
``ModelProto`` subset needed for the pose-model zoo directly in the
protobuf wire format, and parses it back for the evaluator
(:mod:`.onnx_eval`) and for ``.onnx`` weight files.
Field numbers follow the public ``onnx/onnx.proto`` schema (stable since
ONNX 1.0); artifacts written here load with stock ``onnx.load`` /
onnxruntime / MNN converters.

Parity role: the artifact surface of the reference's torch→ONNX export
(deep_hrnet/tools/export.py:21-56), produced without torch or onnx.

Scope: FLOAT/INT64 tensors, single-graph models, the attribute kinds
used by opset-11 vision ops (f/i/s/ints/floats/strings).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = 1, 2, 3, 6, 7, 9, 10, 11

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.int64): INT64,
    np.dtype(np.int32): INT32,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# AttributeProto.AttributeType
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------------------------------------------------------- writer

def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldnum: int, wire: int) -> bytes:
    return _varint((fieldnum << 3) | wire)


def _f_varint(fieldnum: int, v: int) -> bytes:
    return _tag(fieldnum, 0) + _varint(v)


def _f_bytes(fieldnum: int, payload: bytes) -> bytes:
    return _tag(fieldnum, 2) + _varint(len(payload)) + payload


def _f_str(fieldnum: int, s: str) -> bytes:
    return _f_bytes(fieldnum, s.encode("utf-8"))


def _f_float32(fieldnum: int, v: float) -> bytes:
    return _tag(fieldnum, 5) + struct.pack("<f", float(v))


@dataclass
class TensorP:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    name: str
    array: np.ndarray

    def dumps(self) -> bytes:
        a = np.ascontiguousarray(self.array)
        if a.dtype not in _NP_TO_ONNX:
            raise TypeError(f"unsupported dtype {a.dtype} for {self.name}")
        out = b"".join(_f_varint(1, int(d)) for d in a.shape)
        out += _f_varint(2, _NP_TO_ONNX[a.dtype])
        out += _f_str(8, self.name)
        out += _f_bytes(9, a.astype(a.dtype.newbyteorder("<")).tobytes())
        return out


@dataclass
class AttrP:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    name: str
    value: Union[float, int, str, bytes, Sequence, np.ndarray, TensorP]
    kind: Optional[int] = None  # force a type (e.g. A_FLOAT for int-valued)

    def dumps(self) -> bytes:
        out = _f_str(1, self.name)
        v, k = self.value, self.kind
        if k is None:
            if isinstance(v, TensorP):
                k = A_TENSOR
            elif isinstance(v, bool) or isinstance(v, (int, np.integer)):
                k = A_INT
            elif isinstance(v, float):
                k = A_FLOAT
            elif isinstance(v, (str, bytes)):
                k = A_STRING
            elif isinstance(v, (list, tuple, np.ndarray)):
                seq = list(v)
                if seq and isinstance(seq[0], (str, bytes)):
                    k = A_STRINGS
                elif any(isinstance(x, float) for x in seq):
                    k = A_FLOATS
                else:
                    k = A_INTS
            else:
                raise TypeError(f"attr {self.name}: {type(v)}")
        if k == A_FLOAT:
            out += _f_float32(2, v)
        elif k == A_INT:
            out += _f_varint(3, int(v))
        elif k == A_STRING:
            out += _f_bytes(4, v.encode() if isinstance(v, str) else v)
        elif k == A_TENSOR:
            out += _f_bytes(5, v.dumps())
        elif k == A_FLOATS:
            for x in v:
                out += _f_float32(7, x)
        elif k == A_INTS:
            for x in v:
                out += _f_varint(8, int(x))
        elif k == A_STRINGS:
            for x in v:
                out += _f_bytes(9, x.encode() if isinstance(x, str) else x)
        else:
            raise ValueError(f"attr kind {k}")
        out += _f_varint(20, k)
        return out


@dataclass
class NodeP:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)

    def dumps(self) -> bytes:
        out = b"".join(_f_str(1, s) for s in self.inputs)
        out += b"".join(_f_str(2, s) for s in self.outputs)
        if self.name:
            out += _f_str(3, self.name)
        out += _f_str(4, self.op_type)
        for aname, aval in self.attrs.items():
            attr = aval if isinstance(aval, AttrP) else AttrP(aname, aval)
            out += _f_bytes(5, attr.dumps())
        return out


def _value_info(name: str, shape: Sequence, elem_type: int = FLOAT) -> bytes:
    """ValueInfoProto{name=1, type=2:TypeProto{tensor_type=1:
    Tensor{elem_type=1, shape=2:TensorShapeProto{dim=1}}}}."""
    dims = b""
    for d in shape:
        if isinstance(d, str):  # symbolic (dim_param=2)
            dim = _f_str(2, d)
        else:
            dim = _f_varint(1, int(d))
        dims += _f_bytes(1, dim)
    tensor = _f_varint(1, elem_type) + _f_bytes(2, dims)
    typ = _f_bytes(1, tensor)
    return _f_str(1, name) + _f_bytes(2, typ)


@dataclass
class GraphP:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    name: str
    nodes: List[NodeP]
    inputs: List  # (name, shape) tuples
    outputs: List
    initializers: List[TensorP]

    def dumps(self) -> bytes:
        out = b"".join(_f_bytes(1, n.dumps()) for n in self.nodes)
        out += _f_str(2, self.name)
        out += b"".join(_f_bytes(5, t.dumps()) for t in self.initializers)
        out += b"".join(_f_bytes(11, _value_info(n, s)) for n, s in self.inputs)
        out += b"".join(_f_bytes(12, _value_info(n, s)) for n, s in self.outputs)
        return out


def dump_model(graph: GraphP, opset: int = 11,
               producer: str = "udp_pose_tpu",
               ir_version: int = 6,
               doc: str = "") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    doc_string=6, graph=7, opset_import=8:{domain=1, version=2}."""
    out = _f_varint(1, ir_version)
    out += _f_str(2, producer)
    out += _f_str(3, "0.2")
    if doc:
        out += _f_str(6, doc)
    out += _f_bytes(7, graph.dumps())
    out += _f_bytes(8, _f_str(1, "") + _f_varint(2, opset))
    return out


# ---------------------------------------------------------------- reader

def _read_varint(buf: bytes, i: int):
    shift, v = 0, 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message payload."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"wire type {wire}")
        yield fnum, wire, v


def _parse_tensor(buf: bytes):
    dims, dtype, name, raw = [], FLOAT, "", b""
    float_data, int64_data, int32_data = [], [], []
    for fnum, wire, v in _fields(buf):
        if fnum == 1:
            if wire == 2:  # packed
                j = 0
                while j < len(v):
                    d, j = _read_varint(v, j)
                    dims.append(d)
            else:
                dims.append(v)
        elif fnum == 2:
            dtype = v
        elif fnum == 4:
            if wire == 2:
                float_data.extend(np.frombuffer(v, "<f4").tolist())
            else:
                float_data.append(v)
        elif fnum == 5 and wire == 2:
            j = 0
            while j < len(v):
                d, j = _read_varint(v, j)
                int32_data.append(d)
        elif fnum == 7:
            if wire == 2:
                j = 0
                while j < len(v):
                    d, j = _read_varint(v, j)
                    int64_data.append(d)
            else:
                int64_data.append(v)
        elif fnum == 8:
            name = v.decode()
        elif fnum == 9:
            raw = v
    np_dtype = _ONNX_TO_NP[dtype]
    if raw:
        arr = np.frombuffer(raw, np_dtype.newbyteorder("<")).astype(np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(
            [x - (1 << 64) if x >= (1 << 63) else x for x in int64_data],
            np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    return TensorP(name, arr.reshape(dims))


def _parse_attr(buf: bytes):
    name, kind = "", None
    vals = {}
    for fnum, wire, v in _fields(buf):
        if fnum == 1:
            name = v.decode()
        elif fnum == 2:
            vals["f"] = v
        elif fnum == 3:
            vals["i"] = v - (1 << 64) if v >= (1 << 63) else v
        elif fnum == 4:
            vals["s"] = v
        elif fnum == 5:
            vals["t"] = _parse_tensor(v)
        elif fnum == 7:
            vals.setdefault("floats", [])
            if wire == 2:
                vals["floats"].extend(np.frombuffer(v, "<f4").tolist())
            else:
                vals["floats"].append(v)
        elif fnum == 8:
            vals.setdefault("ints", [])
            if wire == 2:
                j = 0
                while j < len(v):
                    d, j = _read_varint(v, j)
                    vals["ints"].append(d - (1 << 64) if d >= (1 << 63) else d)
            else:
                vals["ints"].append(v - (1 << 64) if v >= (1 << 63) else v)
        elif fnum == 9:
            vals.setdefault("strings", []).append(v)
        elif fnum == 20:
            kind = v
    order = {A_FLOAT: "f", A_INT: "i", A_STRING: "s", A_TENSOR: "t",
             A_FLOATS: "floats", A_INTS: "ints", A_STRINGS: "strings"}
    if kind in order and order[kind] in vals:
        value = vals[order[kind]]
    elif vals:
        value = next(iter(vals.values()))
    else:
        value = [] if kind in (A_INTS, A_FLOATS, A_STRINGS) else 0
    return name, value


def _parse_node(buf: bytes) -> NodeP:
    node = NodeP("", [], [])
    for fnum, _w, v in _fields(buf):
        if fnum == 1:
            node.inputs.append(v.decode())
        elif fnum == 2:
            node.outputs.append(v.decode())
        elif fnum == 3:
            node.name = v.decode()
        elif fnum == 4:
            node.op_type = v.decode()
        elif fnum == 5:
            aname, aval = _parse_attr(v)
            node.attrs[aname] = aval
    return node


def _parse_value_info(buf: bytes):
    name, shape = "", []
    for fnum, _w, v in _fields(buf):
        if fnum == 1:
            name = v.decode()
        elif fnum == 2:
            for f2, _w2, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            for f4, _w4, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dim = None
                                    for f5, _w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim = v5
                                        elif f5 == 2:
                                            dim = v5.decode()
                                    shape.append(dim)
    return name, shape


def _parse_graph(buf: bytes) -> GraphP:
    g = GraphP("", [], [], [], [])
    for fnum, _w, v in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(v))
        elif fnum == 2:
            g.name = v.decode()
        elif fnum == 5:
            g.initializers.append(_parse_tensor(v))
        elif fnum == 11:
            g.inputs.append(_parse_value_info(v))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(v))
    return g


@dataclass
class ModelP:
    ir_version: int
    opset: int
    producer: str
    graph: GraphP


def load_model(data: bytes) -> ModelP:
    ir, opset, producer, graph = 0, 0, "", None
    for fnum, _w, v in _fields(data):
        if fnum == 1:
            ir = v
        elif fnum == 2:
            producer = v.decode()
        elif fnum == 7:
            graph = _parse_graph(v)
        elif fnum == 8:
            for f2, _w2, v2 in _fields(v):
                if f2 == 2:
                    opset = max(opset, v2)
    if graph is None:
        raise ValueError("no GraphProto in model")
    return ModelP(ir, opset, producer, graph)
