"""Minimal ONNX loader and executor on torch ops (counterpart of
``tts_max_tpu/utils/onnx_lite.py``; no ``onnx`` or ``onnxruntime``).

The DNSMOS reward's published weights exist only as ONNX graphs. This
module parses the protobuf wire format of an ONNX ``ModelProto`` by hand
(the JAX package's parser, copied) and executes the graph with torch ops.
The op set is the JAX module's: the small Keras/torch-exported CNN and
dense models of perceptual scoring. It is an interpreter for trusted local
model files, not a general runtime.

Values are of two kinds, as in the JAX module. Shape-like host values
(``Shape`` outputs, integer initializers feeding ``Reshape``, ``Slice``,
``Pad`` and the like, ``Constant`` nodes) stay numpy arrays on the host and
ops on host values alone run in numpy; tensors (the feeds and what is
computed from them) are torch tensors on the run's device. Float
initializers are copied to the device once per graph and device. There is
nothing to compile: ``make_runner`` is a plain runner.

A small encoder (``build_model_bytes`` and friends, copied from the JAX
module) writes valid ONNX files without the onnx package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tts_max_tpu_torch.device import resolve_device

# --- protobuf wire-format primitives -----------------------------------------

_WIRE_VARINT, _WIRE_I64, _WIRE_LEN, _WIRE_I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value). LEN values are bytes; varints
    are ints; I32/I64 are raw 4/8-byte chunks."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == _WIRE_VARINT:
            v, i = _read_varint(buf, i)
        elif wt == _WIRE_LEN:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wt == _WIRE_I64:
            v = buf[i : i + 8]
            i += 8
        elif wt == _WIRE_I32:
            v = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _signed(v: int) -> int:
    """Varints are two's-complement 64-bit for int64 fields."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _packed_varints(v, wt) -> list[int]:
    if wt == _WIRE_VARINT:
        return [_signed(v)]
    out, i = [], 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(_signed(x))
    return out


# --- ONNX message parsing ------------------------------------------------------

# TensorProto.DataType
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype_code = 1
    raw = b""
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    name = ""
    for fno, wt, v in _iter_fields(buf):
        if fno == 1:
            dims.extend(_packed_varints(v, wt))
        elif fno == 2:
            dtype_code = v
        elif fno == 4:
            if wt == _WIRE_I32:
                float_data.append(struct.unpack("<f", v)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(v) // 4}f", v)
                )
        elif fno == 5:
            int32_data.extend(_packed_varints(v, wt))
        elif fno == 7:
            int64_data.extend(_packed_varints(v, wt))
        elif fno == 8:
            name = v.decode()
        elif fno == 9:
            raw = v
        elif fno == 11:
            if wt == _WIRE_I64:
                double_data.append(struct.unpack("<d", v)[0])
            else:
                double_data.extend(struct.unpack(f"<{len(v) // 8}d", v))
    dtype = _DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype code {dtype_code}")
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return name, arr.reshape(dims)


@dataclass
class Attribute:
    name: str = ""
    f: float | None = None
    i: int | None = None
    s: bytes | None = None
    t: np.ndarray | None = None
    floats: list[float] = field(default_factory=list)
    ints: list[int] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.t, self.s, self.f, self.i):
            if v is not None:
                return v
        return self.ints or self.floats


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for fno, wt, v in _iter_fields(buf):
        if fno == 1:
            a.name = v.decode()
        elif fno == 2:
            a.f = struct.unpack("<f", v)[0]
        elif fno == 3:
            a.i = _signed(v)
        elif fno == 4:
            a.s = v
        elif fno == 5:
            a.t = _parse_tensor(v)[1]
        elif fno == 6:
            if wt == _WIRE_I32:
                a.floats.append(struct.unpack("<f", v)[0])
            else:
                a.floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
        elif fno == 7:
            a.ints.extend(_packed_varints(v, wt))
    return a


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str
    attrs: dict[str, Attribute]

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


def _parse_node(buf: bytes) -> Node:
    inputs, outputs, attrs = [], [], {}
    op_type = name = ""
    for fno, _wt, v in _iter_fields(buf):
        if fno == 1:
            inputs.append(v.decode())
        elif fno == 2:
            outputs.append(v.decode())
        elif fno == 3:
            name = v.decode()
        elif fno == 4:
            op_type = v.decode()
        elif fno == 5:
            a = _parse_attribute(v)
            attrs[a.name] = a
    return Node(op_type, inputs, outputs, name, attrs)


def _value_info_name(buf: bytes) -> str:
    for fno, _wt, v in _iter_fields(buf):
        if fno == 1:
            return v.decode()
    return ""


@dataclass
class Graph:
    nodes: list[Node]
    initializers: dict[str, np.ndarray]
    input_names: list[str]
    output_names: list[str]
    # float initializers on each device a run used (``_device_initializers``)
    on_device: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def feed_names(self) -> list[str]:
        """Graph inputs that are not initializer-backed (the real feeds)."""
        return [n for n in self.input_names if n not in self.initializers]


def _parse_graph(buf: bytes) -> Graph:
    nodes, inits, ins, outs = [], {}, [], []
    for fno, _wt, v in _iter_fields(buf):
        if fno == 1:
            nodes.append(_parse_node(v))
        elif fno == 5:
            name, arr = _parse_tensor(v)
            inits[name] = arr
        elif fno == 11:
            ins.append(_value_info_name(v))
        elif fno == 12:
            outs.append(_value_info_name(v))
    return Graph(nodes, inits, ins, outs)


def parse_model(data: bytes) -> Graph:
    """ONNX ModelProto bytes -> Graph."""
    for fno, _wt, v in _iter_fields(data):
        if fno == 7:
            return _parse_graph(v)
    raise ValueError("no graph in ONNX model")


def load_model(path: str) -> Graph:
    with open(path, "rb") as f:
        return parse_model(f.read())


# --- executor -------------------------------------------------------------------

# Host values (np.ndarray) carry concrete shape/index data; device values
# (torch tensors) carry tensors. An op whose inputs are all host values runs
# in numpy, keeping Shape -> Reshape chains on the host.


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, list, tuple))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


def _dev(x, device: torch.device) -> torch.Tensor:
    """A value as a tensor on ``device``. A float64 host value becomes fp32,
    as ``jnp.asarray`` makes it with 64-bit types off."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _explicit_pads(node: Node, x, kernel_shape, strides, dilations):
    """Resolve pads from the ``pads`` attr or ``auto_pad``; returns per-spatial
    (lo, hi) pairs."""
    nd = len(kernel_shape)
    auto = node.attr("auto_pad", b"NOTSET")
    auto = auto.decode() if isinstance(auto, bytes) else auto
    if auto in ("NOTSET", ""):
        pads = node.attr("pads", [0] * (2 * nd))
        return [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if auto == "VALID":
        return [(0, 0)] * nd
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(nd):
        in_dim = x.shape[2 + i]
        eff_k = (kernel_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])  # ceil
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
        out.append((lo, total - lo))
    return out


def _pad_spatial(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    """Pad the trailing spatial axes by per-axis (lo, hi) pairs."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _op_conv(node: Node, dev, x, w, b=None):
    w = _dev(w, dev)
    nd = w.ndim - 2
    kernel_shape = [int(k) for k in node.attr("kernel_shape", list(w.shape[2:]))]
    strides = [int(s) for s in node.attr("strides", [1] * nd)]
    dilations = [int(d) for d in node.attr("dilations", [1] * nd)]
    group = int(node.attr("group", 1))
    x = _dev(x, dev)
    pads = _explicit_pads(node, x, kernel_shape, strides, dilations)
    y = _CONV[nd](_pad_spatial(x, pads, 0.0), w, stride=strides, dilation=dilations,
                  groups=group)
    if b is not None:
        y = y + _dev(b, dev).reshape((1, -1) + (1,) * nd)
    return y


def _window_sum(x: torch.Tensor, kernel_shape, strides) -> torch.Tensor:
    """Sum over each pooling window (no padding): an average pool times the
    window size, through 2-D/3-D pooling with a divisor of 1 (1-D pools as
    2-D with a unit axis)."""
    nd = len(kernel_shape)
    if nd == 1:
        return _window_sum(x[..., None], kernel_shape + [1], strides + [1])[..., 0]
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, kernel_shape, strides, divisor_override=1)


def _pool(node: Node, dev, x, is_avg: bool):
    kernel_shape = [int(k) for k in node.attr("kernel_shape")]
    nd = len(kernel_shape)
    strides = [int(s) for s in node.attr("strides", [1] * nd)]
    x = _dev(x, dev)
    pads = _explicit_pads(node, x, kernel_shape, strides, [1] * nd)
    if not is_avg:
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
        return pool(_pad_spatial(x, pads, -float("inf")), kernel_shape, strides)
    y = _window_sum(_pad_spatial(x, pads, 0.0), kernel_shape, strides)
    if int(node.attr("count_include_pad", 0)) or all(p == (0, 0) for p in pads):
        return y / np.prod(kernel_shape)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return y / _window_sum(_pad_spatial(ones, pads, 0.0), kernel_shape, strides)


def _op_gemm(node: Node, dev, a, b, c=None):
    alpha = float(node.attr("alpha", 1.0))
    beta = float(node.attr("beta", 1.0))
    a, b = _dev(a, dev), _dev(b, dev)
    if int(node.attr("transA", 0)):
        a = a.transpose(-1, -2)
    if int(node.attr("transB", 0)):
        b = b.transpose(-1, -2)
    y = alpha * (a @ b)
    if c is not None:
        y = y + beta * _dev(c, dev)
    return y


def _op_batchnorm(node: Node, dev, x, scale, bias, mean, var):
    eps = float(node.attr("epsilon", 1e-5))
    x = _dev(x, dev)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale, bias, mean, var = (_dev(t, dev).reshape(shape) for t in (scale, bias, mean, var))
    return (x - mean) * (scale * torch.rsqrt(var + eps)) + bias


def _select(x, axis: int, idx: list[int]):
    """Entries ``idx`` of ``x`` along ``axis`` (host or device)."""
    if _is_host(x):
        return np.take(np.asarray(x), idx, axis=axis)
    return x.index_select(axis, torch.as_tensor(idx, dtype=torch.long, device=x.device))


def _op_slice(node: Node, dev, x, *rest):
    if rest:  # opset >= 10: starts, ends, [axes], [steps] as inputs
        starts = _np(rest[0]).tolist()
        ends = _np(rest[1]).tolist()
        axes = _np(rest[2]).tolist() if len(rest) > 2 else list(range(len(starts)))
        steps = _np(rest[3]).tolist() if len(rest) > 3 else [1] * len(starts)
    else:
        starts = list(node.attr("starts"))
        ends = list(node.attr("ends"))
        axes = list(node.attr("axes", list(range(len(starts)))))
        steps = [1] * len(starts)
    ndim = len(x.shape)
    for s, e, a, st in zip(starts, ends, axes, steps):
        # ONNX clamps out-of-range ends (INT_MAX is common)
        e = None if e >= np.iinfo(np.int64).max // 2 else int(e)
        a = int(a) % ndim
        idx = list(range(x.shape[a]))[slice(int(s), e, int(st))]
        x = _select(x, a, idx)
    return x


def _edge_index(n: int, lo: int, hi: int, mode: str) -> list[int]:
    """Source index of each padded position along one axis (``jnp.pad``'s
    reflect and edge modes)."""
    out = []
    for i in range(-lo, n + hi):
        j = i
        if mode == "edge":
            j = min(max(i, 0), n - 1)
        else:
            period = 2 * (n - 1) if n > 1 else 1
            j = abs(i) % period if n > 1 else 0
            j = period - j if j >= n else j
        out.append(j)
    return out


def _op_pad(node: Node, dev, x, *rest):
    mode = node.attr("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if rest:
        pads = _np(rest[0]).tolist()
        cval = (float(_np(rest[1]).reshape(-1)[0]) if len(rest) > 1 and rest[1] is not None
                else 0.0)
    else:
        pads = list(node.attr("pads"))
        cval = float(node.attr("value", 0.0))
    nd = len(pads) // 2
    widths = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if _is_host(x):
        x = np.asarray(x)
        if mode == "constant":
            return np.pad(x, widths, constant_values=cval)
        return np.pad(x, widths, mode={"reflect": "reflect", "edge": "edge"}[mode])
    if mode == "constant":
        return F.pad(x, [p for w in reversed(widths) for p in w], value=cval)
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    for axis, (lo, hi) in enumerate(widths):
        if lo or hi:
            x = _select(x, axis, _edge_index(x.shape[axis], lo, hi, mode))
    return x


def _reduce(kind: str, node: Node, x, *rest):
    if rest and rest[0] is not None:
        axes = tuple(int(a) for a in _np(rest[0]).reshape(-1))
    else:
        axes = node.attr("axes", None)
        axes = tuple(int(a) for a in axes) if axes else None
    keep = bool(int(node.attr("keepdims", 1)))
    if _is_host(x):
        return getattr(np, kind)(np.asarray(x), axis=axes, keepdims=keep)
    dims = tuple(range(x.ndim)) if axes is None else axes
    fn = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax, "min": torch.amin}[kind]
    return fn(x, dim=dims, keepdim=keep)


_BINARY = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": torch.div,
    "Pow": torch.pow,
    "Min": torch.minimum,
    "Max": torch.maximum,
    "MatMul": torch.matmul,
    "Greater": torch.gt,
    "Less": torch.lt,
    "Equal": torch.eq,
    "And": torch.logical_and,
    "Or": torch.logical_or,
}

_BINARY_HOST = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply, "Div": np.divide,
    "Pow": np.power, "Min": np.minimum, "Max": np.maximum, "MatMul": np.matmul,
    "Greater": np.greater, "Less": np.less, "Equal": np.equal,
    "And": np.logical_and, "Or": np.logical_or,
}

_UNARY = {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Sqrt": torch.sqrt,
    "Exp": torch.exp,
    "Log": torch.log,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Erf": torch.erf,
    "Not": torch.logical_not,
    "Identity": lambda x: x,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)),
    "Reciprocal": torch.reciprocal,
}


def _eval_node(node: Node, vals: list, dev: torch.device):
    op = node.op_type
    x = vals[0] if vals else None
    if op in _UNARY:
        f = _UNARY[op]
        if _is_host(x):
            return f(torch.from_numpy(np.array(x))).numpy()
        return f(x)
    if op in _BINARY:
        if all(_is_host(v) for v in vals):
            return np.asarray(_BINARY_HOST[op](_np(vals[0]), _np(vals[1])))
        return _BINARY[op](_dev(vals[0], dev), _dev(vals[1], dev))
    if op == "Conv":
        return _op_conv(node, dev, *vals)
    if op == "Gemm":
        return _op_gemm(node, dev, *vals)
    if op == "BatchNormalization":
        return _op_batchnorm(node, dev, *vals)
    if op == "MaxPool":
        return _pool(node, dev, x, is_avg=False)
    if op == "AveragePool":
        return _pool(node, dev, x, is_avg=True)
    if op in ("GlobalAveragePool", "GlobalMaxPool"):
        x = _dev(x, dev)
        dims = tuple(range(2, x.ndim))
        return (x.mean(dim=dims, keepdim=True) if op == "GlobalAveragePool"
                else x.amax(dim=dims, keepdim=True))
    if op == "Reshape":
        shape = [int(s) for s in _np(vals[1]).reshape(-1)]
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return x.reshape(shape)
    if op == "Transpose":
        perm = [int(p) for p in node.attr("perm", list(range(len(x.shape)))[::-1])]
        return np.transpose(x, perm) if _is_host(x) else x.permute(perm)
    if op == "Flatten":
        ax = int(node.attr("axis", 1))
        lead = int(np.prod(x.shape[:ax])) if ax else 1
        return x.reshape(lead, -1)
    if op == "Squeeze":
        axes = vals[1] if len(vals) > 1 else node.attr("axes", None)
        if axes is None:
            return x.reshape([d for d in x.shape if d != 1])
        axes = sorted(int(a) % len(x.shape) for a in _np(axes).reshape(-1))
        return x.reshape([d for i, d in enumerate(x.shape) if i not in axes])
    if op == "Unsqueeze":
        axes = vals[1] if len(vals) > 1 else node.attr("axes")
        y = x
        for a in sorted(int(a) for a in _np(axes).reshape(-1)):
            y = np.expand_dims(y, a) if _is_host(y) else y.unsqueeze(a)
        return y
    if op == "Concat":
        ax = int(node.attr("axis"))
        if all(_is_host(v) for v in vals):
            return np.concatenate([_np(v) for v in vals], axis=ax)
        return torch.cat([_dev(v, dev) for v in vals], dim=ax)
    if op == "Slice":
        return _op_slice(node, dev, *vals)
    if op == "Pad":
        return _op_pad(node, dev, *vals)
    if op == "Shape":
        return np.asarray(x.shape, dtype=np.int64)  # on the host
    if op == "Gather":
        ax = int(node.attr("axis", 0))
        idx = vals[1]
        if _is_host(x) and _is_host(idx):
            return np.take(_np(x), _np(idx).astype(np.int64), axis=ax)
        x = _dev(x, dev)
        ax %= x.ndim
        i = _dev(np.asarray(idx, dtype=np.int64) if _is_host(idx) else idx, x.device).long()
        i = torch.where(i < 0, i + x.shape[ax], i)
        out = x.index_select(ax, i.reshape(-1))
        return out.reshape(tuple(x.shape[:ax]) + tuple(i.shape) + tuple(x.shape[ax + 1:]))
    if op == "Cast":
        to = _DTYPES[int(node.attr("to"))]
        if _is_host(x):
            return _np(x).astype(to)
        dt = _torch_dtype(to)
        return x.to(torch.float32 if dt == torch.float64 else dt)
    if op == "Clip":
        lo = vals[1] if len(vals) > 1 else node.attr("min", None)
        hi = vals[2] if len(vals) > 2 else node.attr("max", None)
        y = _dev(x, dev)
        if lo is not None:
            y = torch.maximum(y, _dev(lo, dev).to(y.dtype))
        if hi is not None:
            y = torch.minimum(y, _dev(hi, dev).to(y.dtype))
        return y
    if op == "Softmax":
        return torch.softmax(_dev(x, dev), dim=int(node.attr("axis", -1)))
    if op == "LeakyRelu":
        return F.leaky_relu(_dev(x, dev), float(node.attr("alpha", 0.01)))
    if op == "Elu":
        return F.elu(_dev(x, dev), float(node.attr("alpha", 1.0)))
    if op == "HardSigmoid":
        a = float(node.attr("alpha", 0.2))
        b = float(node.attr("beta", 0.5))
        return torch.clamp(a * _dev(x, dev) + b, 0.0, 1.0)
    if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"):
        return _reduce(op[len("Reduce"):].lower(), node, x, *vals[1:])
    if op == "Constant":
        for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
            a = node.attrs.get(key)
            if a is not None:
                return np.asarray(a.value)
        raise ValueError("Constant node without value")
    if op == "ConstantOfShape":
        val = node.attr("value", np.zeros(1, np.float32))
        shape = [int(s) for s in _np(x).reshape(-1)]
        return np.full(shape, _np(val).reshape(-1)[0], dtype=_np(val).dtype)
    if op == "Expand":
        shape = [int(s) for s in _np(vals[1]).reshape(-1)]
        shape = [
            max(s, d) for s, d in zip(shape, (1,) * (len(shape) - len(x.shape))
                                      + tuple(x.shape))
        ]
        return np.broadcast_to(x, shape) if _is_host(x) else x.expand(shape)
    if op == "Where":
        if all(_is_host(v) for v in vals):
            return np.where(_np(vals[0]), _np(vals[1]), _np(vals[2]))
        return torch.where(*[_dev(v, dev) for v in vals])
    if op == "Dropout":
        return x  # inference mode
    if op == "LRN":
        raise NotImplementedError("LRN")
    raise NotImplementedError(f"ONNX op {op!r} not supported by onnx_lite")


def _device_initializers(graph: Graph, dev: torch.device) -> dict:
    """The graph's initializers for a run on ``dev``: float ones on the
    device (copied once per graph and device), integer ones (shapes, axes,
    indices) on the host."""
    cache = graph.on_device
    if dev not in cache:
        cache[dev] = {
            name: (_dev(a, dev) if np.issubdtype(a.dtype, np.floating) else a)
            for name, a in graph.initializers.items()
        }
    return cache[dev]


def run(graph: Graph, feeds: Mapping[str, Any], device=None) -> list:
    """Execute the graph; returns outputs in graph order.

    Feeds are tensors or numpy arrays; they go to ``device`` (default: the
    device of the first tensor feed, else the card) as tensors.
    """
    if device is None:
        device = next((v.device for v in feeds.values() if isinstance(v, torch.Tensor)),
                      "cuda")
    dev = resolve_device(device)
    env: dict[str, Any] = dict(_device_initializers(graph, dev))
    env.update({k: _dev(v, dev) for k, v in feeds.items()})
    env[""] = None  # optional inputs
    for node in graph.nodes:
        vals = [env[name] for name in node.inputs]
        if node.op_type == "Dropout":
            outs = [vals[0]]
        else:
            result = _eval_node(node, vals, dev)
            outs = list(result) if isinstance(result, tuple) else [result]
        for name, v in zip(node.outputs, outs):
            if name:
                env[name] = v
    return [env[name] for name in graph.output_names]


def make_runner(graph: Graph, device="cuda") -> Callable:
    """``f(**feeds) -> [outputs]`` on ``device`` (the JAX module's
    ``make_jit_runner``; there is nothing to compile here)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def f(**feeds):
        return run(graph, feeds, dev)

    return f


# --- encoder (test support: build ONNX bytes without the onnx package) --------


def _tag(fno: int, wt: int) -> bytes:
    return _enc_varint((fno << 3) | wt)


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(fno: int, payload: bytes) -> bytes:
    return _tag(fno, _WIRE_LEN) + _enc_varint(len(payload)) + payload


_NP_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.int32): 6, np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10, np.dtype(np.float64): 11,
}


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _tag(1, _WIRE_VARINT) + _enc_varint(d)
    out += _tag(2, _WIRE_VARINT) + _enc_varint(_NP_TO_ONNX[arr.dtype])
    out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())
    return out


def encode_attr(name: str, value) -> bytes:
    out = _len_field(1, name.encode())
    if isinstance(value, float):
        out += _tag(2, _WIRE_I32) + struct.pack("<f", value)
        out += _tag(20, _WIRE_VARINT) + _enc_varint(1)  # FLOAT
    elif isinstance(value, bool) or isinstance(value, int):
        out += _tag(3, _WIRE_VARINT) + _enc_varint(int(value) & ((1 << 64) - 1))
        out += _tag(20, _WIRE_VARINT) + _enc_varint(2)  # INT
    elif isinstance(value, (bytes, str)):
        b = value.encode() if isinstance(value, str) else value
        out += _len_field(4, b)
        out += _tag(20, _WIRE_VARINT) + _enc_varint(3)  # STRING
    elif isinstance(value, np.ndarray):
        out += _len_field(5, encode_tensor("", value))
        out += _tag(20, _WIRE_VARINT) + _enc_varint(4)  # TENSOR
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for f in value:
            out += _tag(6, _WIRE_I32) + struct.pack("<f", f)
        out += _tag(20, _WIRE_VARINT) + _enc_varint(6)  # FLOATS
    elif isinstance(value, (list, tuple)):
        for i in value:
            out += _tag(7, _WIRE_VARINT) + _enc_varint(int(i) & ((1 << 64) - 1))
        out += _tag(20, _WIRE_VARINT) + _enc_varint(7)  # INTS
    else:
        raise TypeError(type(value))
    return out


def encode_node(op_type: str, inputs, outputs, **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(4, op_type.encode())
    for k, v in attrs.items():
        out += _len_field(5, encode_attr(k, v))
    return out


def _encode_value_info(name: str) -> bytes:
    return _len_field(1, name.encode())


def build_model_bytes(
    nodes: list[bytes],
    inputs: list[str],
    outputs: list[str],
    initializers: dict[str, np.ndarray] | None = None,
) -> bytes:
    g = b""
    for n in nodes:
        g += _len_field(1, n)
    g += _len_field(2, b"onnx_lite_test")
    for name, arr in (initializers or {}).items():
        g += _len_field(5, encode_tensor(name, arr))
    for i in inputs:
        g += _len_field(11, _encode_value_info(i))
    for o in outputs:
        g += _len_field(12, _encode_value_info(o))
    # ModelProto: ir_version (1) + graph (7) + opset_import (8) left minimal
    return _tag(1, _WIRE_VARINT) + _enc_varint(8) + _len_field(7, g)
