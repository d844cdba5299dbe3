"""Reader and writer of the safetensors file format, so that checkpoints
load and save where the ``safetensors`` package is not installed.

The format: an 8-byte little-endian unsigned header length N, N bytes of
JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` and an
optional ``"__metadata__"`` map of strings; padded with spaces to a multiple
of 8), then the tensors' raw little-endian bytes, offsets counted from the
end of the header.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the CPU) to ``path``."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of the file at ``path``, on the CPU."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    header = json.loads(bytes(buf[8:8 + n]))
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, info in header.items():
        dtype = _DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        flat = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin)
        out[name] = flat.reshape(shape).clone()
    return out
