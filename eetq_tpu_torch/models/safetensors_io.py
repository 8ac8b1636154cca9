"""A reader and a writer of the safetensors format, without the library.

The format: an 8-byte little-endian length n, a JSON header of n bytes
mapping each tensor's name to its ``dtype`` code, ``shape`` and
``data_offsets`` [begin, end) (relative to the end of the header, 64-bit
values), an optional ``__metadata__`` dict of strings, then the raw
little-endian bytes of every tensor.

The JAX package reads and writes checkpoints through the `safetensors`
package (`eetq_tpu/models/hf.py:108, 131, 375`), which the port does not
depend on. The reader takes what the JAX package's reader takes: the dtypes
of ``safe_open(framework="numpy")``, and BF16, which numpy understands once
JAX is imported (JAX registers ml_dtypes' bfloat16 with numpy). Any other
(the F8 types) raises `TypeError`. The writer writes I8, F16 and F32, the
dtypes of a quantized checkpoint and of an fp16 one. Bytes are taken as they
lie in memory: a little-endian host.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import struct
from typing import Callable

import numpy as np
import torch

# the dtypes of `safetensors.numpy` (`_TYPES`), which safe_open(framework="numpy")
# reads, and BF16: each read through the numpy type of its bits
_NUMPY = {
    "BOOL": np.bool_, "U8": np.uint8, "I8": np.int8, "I16": np.int16, "U16": np.uint16,
    "I32": np.int32, "U32": np.uint32, "I64": np.int64, "U64": np.uint64,
    "F16": np.float16, "F32": np.float32, "F64": np.float64, "C64": np.complex64,
    "BF16": np.uint16,
}
DTYPES = {code: torch.from_numpy(np.empty(0, dt)).dtype for code, dt in _NUMPY.items()}
DTYPES["BF16"] = torch.bfloat16
WRITABLE = {torch.int8: "I8", torch.float16: "F16", torch.float32: "F32"}
_ALIGN = 8  # the header is padded with spaces so that the data starts 8-byte aligned


class SafetensorsFile:
    """One safetensors file, mapped copy-on-write: `get_tensor` gives a CPU
    tensor over the mapped bytes, copying nothing (a misaligned tensor, which
    the library's own files never hold, is copied). The mapping lives as
    long as the file object or a tensor it gave."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata = header.pop("__metadata__", None)
        self._entries: dict = header
        self._base = 8 + n

    def keys(self) -> list[str]:
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        entry = self._entries[name]
        code = entry["dtype"]
        if code not in DTYPES:
            raise TypeError(f"{self.path}: tensor {name!r} has dtype {code}, which this reader "
                            f"(as the JAX package's) does not take: {sorted(DTYPES)}")
        dtype, shape = DTYPES[code], tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} spans {end - begin} bytes, "
                             f"{shape} of {code} needs {count * dtype.itemsize}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self._base + begin
        if offset % dtype.itemsize:
            data = bytearray(self._map[offset:offset + end - begin])
            return torch.frombuffer(data, dtype=dtype).reshape(shape)
        # numpy's view holds an export of the mapping (torch.frombuffer
        # would not), so the map cannot be closed under a live tensor
        view = np.frombuffer(self._map, dtype=_NUMPY[code], count=count, offset=offset)
        return torch.from_numpy(view).view(dtype).reshape(shape)

    def close(self) -> None:
        """Unmaps the file unless a tensor it gave is still alive; then the
        mapping goes with the last of them."""
        try:
            self._map.close()
        except BufferError:
            pass

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class Pending:
    """A tensor to be made when the writer reaches it (on any device), so
    that a file of many tensors never needs all of them at once."""

    dtype: torch.dtype
    shape: tuple[int, ...]
    make: Callable[[], torch.Tensor]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


Entry = torch.Tensor | Pending


def header_bytes(entries: dict[str, Entry]) -> bytes:
    """The 8-byte length and the padded JSON header of a file holding
    `entries` in their order, back to back. Offsets are Python ints, so a
    file past 4 GiB gets its 64-bit offsets."""
    header: dict = {}
    pos = 0
    for name, entry in entries.items():
        dtype, shape = entry.dtype, tuple(entry.shape)
        if dtype not in WRITABLE:
            raise TypeError(f"tensor {name!r}: the writer writes {sorted(WRITABLE.values())}, "
                            f"not {dtype}")
        size = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": WRITABLE[dtype], "shape": list(shape),
                        "data_offsets": [pos, pos + size]}
        pos += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-(8 + len(text)) % _ALIGN)
    return struct.pack("<Q", len(text)) + text


class _Staging:
    """One pinned host buffer, grown to the largest tensor copied through it,
    that a card's tensor crosses to the host on its way to the file."""

    def __init__(self):
        self.buf: torch.Tensor | None = None

    def host_bytes(self, t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(-1).view(torch.uint8)
        if not t.is_cuda:
            return flat.contiguous()
        if self.buf is None or self.buf.numel() < flat.numel():
            self.buf = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        out = self.buf[:flat.numel()]
        out.copy_(flat)
        return out


def save_file(entries: dict[str, Entry], path: str) -> None:
    """Write `entries` (tensors on any device, or `Pending` ones made one at
    a time as the writer reaches them) to `path`, in their order. The host
    holds one tensor at a time."""
    staging = _Staging()
    with open(path, "wb") as f:
        f.write(header_bytes(entries))
        for name, entry in entries.items():
            want = entry.dtype, tuple(entry.shape)
            t = entry.make() if isinstance(entry, Pending) else entry
            if (t.dtype, tuple(t.shape)) != want:
                raise ValueError(f"tensor {name!r} came out {t.dtype} {tuple(t.shape)}, "
                                 f"declared {want[0]} {want[1]}")
            if t.numel():
                f.write(staging.host_bytes(t.contiguous()).numpy().data)
