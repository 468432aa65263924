"""Dependency-free ONNX initializer reader (the port's copy of
`adaface_tpu/interop/onnx_weights.py`).

The face recognizer ships as an ONNX model (insightface antelopev2's
glintr100). The port runs the network in PyTorch and needs only the file's
weights and node order. ONNX is protobuf, and `ModelProto.graph.initializer`
(name, dims, data_type, raw_data) and `graph.node` (op_type, inputs) need
only the protobuf wire format, parsed here with no dependency but numpy.

Field numbers (onnx.proto3):
  ModelProto.graph = 7 (GraphProto)
  GraphProto.initializer = 5 (TensorProto), GraphProto.node = 1 (NodeProto)
  TensorProto: dims=1 (int64, repeated), data_type=2, float_data=4,
               int32_data=5, int64_data=7, name=8, raw_data=9
  NodeProto: input=1, output=2, name=3, op_type=4
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yields (field_number, wire_type, payload) over a protobuf message.
    For varint fields the payload is the 8-byte LE encoding of the value."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val.to_bytes(8, "little", signed=False)
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = 1
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    name = ""
    for field, wire, payload in _iter_fields(buf):
        if field == 1:  # dims (varint or packed)
            if wire == 0:
                dims.append(int.from_bytes(payload, "little"))
            else:
                p = 0
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    dims.append(v)
        elif field == 2:
            dtype = int.from_bytes(payload, "little")
        elif field == 4:  # float_data
            if wire == 5:
                floats.append(struct.unpack("<f", payload)[0])
            else:
                floats.extend(np.frombuffer(payload, "<f4").tolist())
        elif field in (5, 7):  # int32_data / int64_data
            if wire == 0:
                ints.append(int.from_bytes(payload, "little"))
            else:
                p = 0
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    ints.append(v)
        elif field == 8:
            name = payload.decode("utf-8")
        elif field == 9:
            raw = payload
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np_dtype)
    elif ints:
        arr = np.asarray(ints, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _parse_node(buf: bytes) -> dict:
    node = {"input": [], "output": [], "name": "", "op_type": ""}
    for field, _, payload in _iter_fields(buf):
        if field == 1:
            node["input"].append(payload.decode("utf-8", "replace"))
        elif field == 2:
            node["output"].append(payload.decode("utf-8", "replace"))
        elif field == 3:
            node["name"] = payload.decode("utf-8", "replace")
        elif field == 4:
            node["op_type"] = payload.decode("utf-8", "replace")
    return node


def load_onnx_weights(path: str, with_graph: bool = False):
    """Returns {initializer name: ndarray}; with_graph=True also returns the
    node list [{op_type, name, input, output}] for name-mapping heuristics."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for field, wire, payload in _iter_fields(buf):
        if field == 7 and wire == 2:
            graph = payload
            break
    if graph is None:
        raise ValueError(f"{path}: no GraphProto found")
    weights: Dict[str, np.ndarray] = {}
    nodes: List[dict] = []
    for field, wire, payload in _iter_fields(graph):
        if field == 5 and wire == 2:
            name, arr = _parse_tensor(payload)
            weights[name] = arr
        elif field == 1 and wire == 2 and with_graph:
            nodes.append(_parse_node(payload))
    return (weights, nodes) if with_graph else weights
