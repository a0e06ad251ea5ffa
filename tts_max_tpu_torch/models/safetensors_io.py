"""A reader and writer of the safetensors format, without the ``safetensors``
package (the card's machine does not have it).

The format: an 8-byte little-endian header length N, then N bytes of JSON
mapping each tensor's name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the data that follows the header) plus an optional
``"__metadata__"`` of strings, then the raw little-endian bytes of every
tensor in C order. The writer pads the header with spaces to a multiple of
8 bytes, as the package does, so the data starts aligned.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the bytes, torch dtype of the tensor).
# BF16 has no numpy dtype: its bytes are read as uint16 and viewed as bf16.
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}
_NAMES = {tdt: name for name, (_, tdt) in _DTYPES.items()}


def read_header(path: str) -> tuple[dict, dict[str, str], int]:
    """(tensor entries, ``__metadata__``, byte offset of the data) of a file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors that own their
    memory (the file is memory-mapped and each tensor copied out)."""
    header, _, start = read_header(path)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode="r")
    out: dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, "
                             f"not one of {sorted(_DTYPES)}")
        np_dtype, torch_dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np_dtype.itemsize or start + end > data.size:
            raise ValueError(f"{path}: tensor {name!r} offsets {begin}..{end} do not "
                             f"fit its shape {shape} and dtype {entry['dtype']}")
        arr = np.frombuffer(data, dtype=np_dtype, count=count, offset=start + begin)
        t = torch.from_numpy(arr.reshape(shape).copy())
        out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 else t
    return out


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A C-contiguous array holding the little-endian bytes of the values
    ``t`` shows, in C order (a transposed view is copied out, not written as
    its base buffer); a file's ``write`` takes it without a copy."""
    t = t.detach().cpu().contiguous()
    arr = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.ascontiguousarray(arr.astype(_DTYPES[_NAMES[t.dtype]][0], copy=False))


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (on any device, in any layout) to ``path``, in name
    order, one tensor in host memory at a time."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in sorted(tensors):
            f.write(_bytes(tensors[name]))
    os.replace(tmp, path)
