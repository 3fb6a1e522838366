"""Jute (ZooKeeper's wire serialization) primitives.

ZooKeeper serializes every protocol record with "jute", a tiny big-endian
binary format.  The reference delegates this to the external zkplus/node
ZooKeeper stack (reference package.json:21); this rebuild implements the
format directly so the framework is standalone.

Primitive encodings (Apache ZooKeeper jute/binary format, stable since 3.x):

    int      4-byte signed big-endian
    long     8-byte signed big-endian
    boolean  1 byte (0 or 1)
    buffer   int length followed by raw bytes; length -1 encodes null
    ustring  buffer holding UTF-8 text
    vector   int count followed by elements; count -1 encodes null
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, TypeVar

from registrar_tpu_torch import malformed

T = TypeVar("T")

_INT = struct.Struct(">i")
_LONG = struct.Struct(">q")

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
LONG_MIN, LONG_MAX = -(2**63), 2**63 - 1


class JuteError(ValueError):
    """Raised on malformed jute data."""


class Writer:
    """Accumulates jute-encoded primitives into a byte buffer."""

    __slots__ = ("_chunks",)

    def __init__(self) -> None:
        self._chunks: List[bytes] = []

    def to_bytes(self) -> bytes:
        return b"".join(self._chunks)

    def append_packed(self, encoded: bytes) -> "Writer":
        """Append pre-packed big-endian bytes (a `struct.Struct.pack` of
        several primitives at once).  The fixed-layout records (Stat, the
        request/reply headers) pack their whole field list in one call —
        the per-field write_int/write_long walk was the hottest encode
        path in the wire stack."""
        self._chunks.append(encoded)
        return self

    def write_int(self, value: int) -> "Writer":
        if not INT_MIN <= value <= INT_MAX:
            raise JuteError(f"int out of range: {value}")
        self._chunks.append(_INT.pack(value))
        return self

    def write_long(self, value: int) -> "Writer":
        if not LONG_MIN <= value <= LONG_MAX:
            raise JuteError(f"long out of range: {value}")
        self._chunks.append(_LONG.pack(value))
        return self

    def write_bool(self, value: bool) -> "Writer":
        self._chunks.append(b"\x01" if value else b"\x00")
        return self

    def write_buffer(self, value: Optional[bytes]) -> "Writer":
        if value is None:
            return self.write_int(-1)
        self.write_int(len(value))
        # bytes payloads (the common case) are immutable — append as-is;
        # only mutable buffer types (bytearray/memoryview) need a copy to
        # pin the encoded frame against later mutation.
        self._chunks.append(value if type(value) is bytes else bytes(value))
        return self

    def write_ustring(self, value: Optional[str]) -> "Writer":
        return self.write_buffer(None if value is None else value.encode("utf-8"))

    def write_vector(
        self, items: Optional[List[T]], write_item: Callable[["Writer", T], object]
    ) -> "Writer":
        if items is None:
            return self.write_int(-1)
        self.write_int(len(items))
        for item in items:
            write_item(self, item)
        return self


class Reader:
    """Reads jute-encoded primitives from any bytes-like buffer.

    ``data`` may be ``bytes`` or a ``memoryview``: the frame
    layer hands replies over as zero-copy views into the transport's
    receive chunks, and every fixed-width primitive decodes in place via
    ``unpack_from`` — no per-field slice is ever materialized.  Variable
    payloads materialize lazily, exactly once, at their read call:
    :meth:`read_buffer` returns real ``bytes`` (payloads escape into
    caches and comparisons, where a view pinning a 64 KB receive chunk
    would be a leak) and :meth:`read_ustring` decodes straight from the
    view without an intermediate ``bytes`` copy.
    """

    __slots__ = ("_data", "_pos")

    def __init__(self, data, pos: int = 0) -> None:
        self._data = data
        self._pos = pos

    @property
    def pos(self) -> int:
        return self._pos

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def _take(self, n: int):
        """Consume ``n`` bytes as a slice of the underlying buffer — a
        copy for ``bytes`` input, a zero-copy subview for ``memoryview``
        input.  Internal: callers materialize or decode as needed."""
        if self.remaining() < n:
            malformed.note("jute")
            raise JuteError(
                f"truncated jute data: need {n} bytes at offset {self._pos}, "
                f"have {self.remaining()}"
            )
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def read_struct(self, st: struct.Struct) -> tuple:
        """Unpack a fixed-layout run of primitives in one call (the decode
        twin of :meth:`Writer.append_packed`)."""
        pos = self._pos
        if len(self._data) - pos < st.size:
            self._take(st.size)  # raises the canonical truncation error
        self._pos = pos + st.size
        return st.unpack_from(self._data, pos)

    def read_int(self) -> int:
        # unpack_from avoids the intermediate slice _take would allocate;
        # ints dominate every frame (lengths, xids, versions), so this is
        # the hottest decode path in the wire stack.
        pos = self._pos
        if len(self._data) - pos < 4:
            self._take(4)  # raises the canonical truncation error
        self._pos = pos + 4
        return _INT.unpack_from(self._data, pos)[0]

    def read_long(self) -> int:
        pos = self._pos
        if len(self._data) - pos < 8:
            self._take(8)
        self._pos = pos + 8
        return _LONG.unpack_from(self._data, pos)[0]

    def read_bool(self) -> bool:
        return self._take(1) != b"\x00"

    def long_at(self, offset: int) -> int:
        """Peek one long at ``pos + offset`` WITHOUT consuming anything.

        The scratch-free fast path for fixed-layout reply bodies that
        only need one field (the heartbeat sweep reads a Stat's
        ``ephemeralOwner`` and nothing else — see
        :func:`registrar_tpu_torch.zk.protocol.stat_owner_from_reply`)."""
        pos = self._pos + offset
        if offset < 0 or len(self._data) - pos < 8:
            malformed.note("jute")
            raise JuteError(
                f"truncated jute data: need 8 bytes at offset {pos}, "
                f"have {max(len(self._data) - pos, 0)}"
            )
        return _LONG.unpack_from(self._data, pos)[0]

    def read_buffer(self) -> Optional[bytes]:
        n = self.read_int()
        if n == -1:
            return None
        if n < -1:
            malformed.note("jute")
            raise JuteError(f"negative buffer length: {n}")
        out = self._take(n)
        # Materialize exactly once: a view escaping here would pin the
        # whole receive chunk for as long as a cached payload lives.
        return out if type(out) is bytes else bytes(out)

    def read_ustring(self) -> Optional[str]:
        n = self.read_int()
        if n == -1:
            return None
        if n < -1:
            malformed.note("jute")
            raise JuteError(f"negative buffer length: {n}")
        # Decode straight off the buffer slice (bytes or view): one
        # string allocation, no intermediate bytes copy for views.
        try:
            return str(self._take(n), "utf-8")
        except UnicodeDecodeError as err:
            malformed.note("jute")
            raise JuteError(f"string not UTF-8: {err}") from err

    def read_vector(self, read_item: Callable[["Reader"], T]) -> Optional[List[T]]:
        n = self.read_int()
        if n == -1:
            return None
        if n < -1:
            malformed.note("jute")
            raise JuteError(f"negative vector length: {n}")
        if n > self.remaining():
            # Every element costs >= 1 byte, so a count beyond the buffer
            # is malformed; reject before allocating the list (a hostile
            # frame could otherwise declare a 2^31 count).
            malformed.note("jute")
            raise JuteError(f"vector length {n} exceeds remaining data")
        return [read_item(self) for _ in range(n)]
