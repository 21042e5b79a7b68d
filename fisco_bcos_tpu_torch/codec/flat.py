"""Flat deterministic binary codec — the framework's canonical byte format
(the port's copy of the JAX package's ``codec/flat.py``, byte for byte).

Plays the role the reference gives Tars IDL serialization
(bcos-tars-protocol/tars/*.tars + protocol/*Impl.*): one canonical encoding
serves as in-memory object payload, network wire format, and storage format,
and — critically — as the *hash preimage* for transactions and block headers,
so it must be deterministic: fixed field order, little-endian fixed-width
ints, u32 length prefixes, no optional/default compression. This is a fresh
format (not Tars): simple enough to write by hand, deterministic by
construction, and friendly to batch padding on device.
"""

from __future__ import annotations

import struct


class FlatWriter:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "FlatWriter":
        self._parts.append(struct.pack("<B", v))
        return self

    def u32(self, v: int) -> "FlatWriter":
        self._parts.append(struct.pack("<I", v))
        return self

    def i64(self, v: int) -> "FlatWriter":
        self._parts.append(struct.pack("<q", v))
        return self

    def u64(self, v: int) -> "FlatWriter":
        self._parts.append(struct.pack("<Q", v))
        return self

    def bytes_(self, v: bytes) -> "FlatWriter":
        self._parts.append(struct.pack("<I", len(v)))
        self._parts.append(bytes(v))
        return self

    def str_(self, v: str) -> "FlatWriter":
        return self.bytes_(v.encode("utf-8"))

    def fixed(self, v: bytes, n: int) -> "FlatWriter":
        if len(v) != n:
            raise ValueError(f"fixed field: expected {n} bytes, got {len(v)}")
        self._parts.append(bytes(v))
        return self

    def seq(self, items, write_item) -> "FlatWriter":
        self._parts.append(struct.pack("<I", len(items)))
        for it in items:
            write_item(self, it)
        return self

    def out(self) -> bytes:
        return b"".join(self._parts)


class FlatReader:
    __slots__ = ("_buf", "_off")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._off = 0

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._buf):
            raise ValueError("flat decode: truncated input")
        v = self._buf[self._off : self._off + n]
        self._off += n
        return v

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def bytes_(self) -> bytes:
        return self._take(self.u32())

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    def fixed(self, n: int) -> bytes:
        return self._take(n)

    def seq(self, read_item) -> list:
        return [read_item(self) for _ in range(self.u32())]

    def at_end(self) -> bool:
        """True when the buffer is exhausted — the probe optional trailing
        sections use (fields added after a release decode as absent on old
        bytes, and absent fields encode to NOTHING, keeping pre-extension
        encodings byte-identical)."""
        return self._off == len(self._buf)

    def done(self) -> None:
        if self._off != len(self._buf):
            raise ValueError(
                f"flat decode: {len(self._buf) - self._off} trailing bytes"
            )
