"""Reading ``.safetensors`` files with or without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its dtype, shape and ``data_offsets`` (begin and end
bytes in the data section that follows the header), and the tensors' raw
little-endian buffers. ``read_safetensors`` reads it with torch alone (the
card's machine has no ``safetensors`` package); ``load_safetensors`` takes
the package where it imports.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": getattr(torch, "float8_e4m3fn", None),
    "F8_E5M2": getattr(torch, "float8_e5m2", None),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, in file order."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    data = memoryview(raw)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which this "
                             "reader does not know")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {info['dtype']} does "
                             f"not fill its {end - begin} bytes")
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        # a copy: the buffer may sit at an offset that is no multiple of the
        # element size, and the tensor must not keep the whole file alive
        flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        out[name] = flat.reshape(shape)
    return out


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """``safetensors.torch.load_file`` where the package imports, else
    ``read_safetensors``."""
    try:
        from safetensors.torch import load_file
    except ImportError:
        return read_safetensors(path)
    return load_file(path)
