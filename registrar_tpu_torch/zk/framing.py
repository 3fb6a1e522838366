"""Length-prefixed frame buffering shared by the client and the server.

ZooKeeper's wire protocol frames every packet with a 4-byte big-endian
length (reference counterpart: the zkplus stack's socket framing; the
Apache client's ClientCnxnSocket does the same).  Both ends of this
rebuild read in bulk — one transport ``read()`` per TCP burst — and
carve complete frames out of the buffered data, instead of issuing two
awaited ``readexactly()`` calls per frame.  Pipelined storms (mkdirp,
heartbeat sweeps, registration fan-outs) land hundreds of frames per
segment, where the per-frame await overhead was a measurable slice of
the hot loops (docs/PERF.md).

Zero-copy carving: the transport's ``read()`` already hands
back a fresh immutable ``bytes`` chunk per call, so the reader keeps a
deque of those chunks AS IS instead of appending them into one growing
``bytearray``.  A frame that lies inside a single chunk — the common
case; a burst chunk carries many whole frames — is returned as a
``memoryview`` into that chunk: no copy on ingest, no copy on carve
(the old buffer made both, plus a memmove-compaction of the tail on
every fill).  Only a frame that genuinely spans chunks is joined into
fresh ``bytes`` (one copy, at the chunk boundary it crosses).  Exhausted
chunks are dropped as consumption passes them, so a 10k-znode sweep
burst never re-copies or even retains the front of the burst — the
growth policy is O(bytes ingested), never quadratic.

The views stay valid for as long as a consumer holds them (the chunks
are immutable and reference-counted); a pending reply future that parses
its body later pins at most its own chunk, briefly.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional

from registrar_tpu_torch import malformed

MAX_FRAME = 4 * 1024 * 1024  # matches real ZK's default jute.maxbuffer
_READ_SIZE = 65536


class FrameReader:
    """Buffered frame carving over an ``asyncio.StreamReader``."""

    __slots__ = ("_reader", "_chunks", "_pos", "_size")

    def __init__(self, reader) -> None:
        self._reader = reader
        #: unconsumed receive chunks, oldest first (immutable bytes)
        self._chunks: Deque[bytes] = deque()
        self._pos = 0  # consumed prefix of _chunks[0]
        self._size = 0  # total unconsumed bytes across all chunks

    async def fill(self) -> bool:
        """Ingest the transport's whole buffered burst; False on EOF/error.

        The first ``read()`` may block; after it returns, everything the
        underlying ``StreamReader`` *already* holds is drained too —
        ``read()`` returns immediately (without suspending, so no new
        data can race in) while its buffer is non-empty, and each 64 KB
        read only takes part of a large burst.  Without the drain loop,
        ``pending()`` reports the burst exhausted at every 64 KB
        boundary and the reply batchers flush once per chunk instead of
        once per burst (ADVICE r5).  ``_buffer`` is asyncio private API:
        when absent, the loop degrades to the old one-read-per-fill
        behavior (64 KB batching granularity), never to an error.

        Each chunk lands in the deque uncopied; see the module
        docstring for the zero-copy carving contract.
        """
        try:
            chunk = await self._reader.read(_READ_SIZE)
        except (ConnectionError, OSError):
            return False
        if not chunk:
            return False
        self._chunks.append(chunk)
        self._size += len(chunk)
        buffered = getattr(self._reader, "_buffer", None)
        while buffered:
            try:
                chunk = await self._reader.read(_READ_SIZE)
            except (ConnectionError, OSError):
                break  # what was ingested so far still carves
            if not chunk:
                break
            self._chunks.append(chunk)
            self._size += len(chunk)
        return True

    async def _need(self, n: int) -> bool:
        while self._size < n:
            if not await self.fill():
                return False
        return True

    def _peek4(self) -> int:
        """The next 4 bytes as a signed big-endian int, not consumed.
        Caller guarantees at least 4 bytes are buffered."""
        first = self._chunks[0]
        pos = self._pos
        if len(first) - pos >= 4:
            return int.from_bytes(first[pos : pos + 4], "big", signed=True)
        out = bytearray(first[pos:])
        for chunk in list(self._chunks)[1:]:
            out += chunk[: 4 - len(out)]
            if len(out) == 4:
                break
        return int.from_bytes(out, "big", signed=True)

    def _skip(self, n: int) -> None:
        """Consume ``n`` buffered bytes without materializing them."""
        self._size -= n
        chunks = self._chunks
        while n:
            first = chunks[0]
            avail = len(first) - self._pos
            if n < avail:
                self._pos += n
                return
            n -= avail
            chunks.popleft()
            self._pos = 0

    def _take(self, n: int):
        """Consume ``n`` buffered bytes: a zero-copy view (or the whole
        chunk itself) when they lie within one chunk, joined ``bytes``
        when they span chunks.  Caller guarantees ``n <= _size``."""
        if n == 0:
            return b""
        self._size -= n
        chunks = self._chunks
        first = chunks[0]
        pos = self._pos
        end = pos + n
        flen = len(first)
        if end < flen:
            self._pos = end
            return memoryview(first)[pos:end]
        if end == flen:
            chunks.popleft()
            self._pos = 0
            return first if pos == 0 else memoryview(first)[pos:]
        parts = [memoryview(first)[pos:]]
        need = n - (flen - pos)
        chunks.popleft()
        self._pos = 0
        while need:
            chunk = chunks[0]
            clen = len(chunk)
            if clen <= need:
                parts.append(chunk)
                need -= clen
                chunks.popleft()
            else:
                parts.append(memoryview(chunk)[:need])
                self._pos = need
                need = 0
        return b"".join(parts)

    def carve(self) -> List[bytes]:
        """Every complete frame payload currently buffered, in order —
        zero-copy views for within-chunk frames (see module docstring).

        Raises ConnectionError on a corrupt length prefix — the stream
        has lost framing and cannot be resynchronized.
        """
        out: List[bytes] = []
        while self._size >= 4:
            length = self._peek4()
            if length < 0 or length > MAX_FRAME:
                malformed.note("zk_framing")
                raise ConnectionError(f"bad frame length {length}")
            if self._size - 4 < length:
                break
            self._skip(4)
            out.append(self._take(length))
        return out

    def pending(self) -> bool:
        """True when a complete frame is already buffered (reply batchers
        hold their flush until the input burst is exhausted)."""
        if self._size < 4:
            return False
        length = self._peek4()
        return 0 <= length <= self._size - 4

    def frame_nowait(self):
        """A complete buffered frame RIGHT NOW, or None.

        The server request loop's fast lane: a pipelined
        sweep leaves hundreds of complete frames buffered after one
        fill, and awaiting :meth:`frame` per request costs a coroutine
        per frame just to discover the bytes are already here.  Returns
        None when no complete frame is buffered — including a corrupt
        length, which is deferred to the awaited :meth:`frame` path so
        the error contract stays in one place.
        """
        if self._size < 4:
            return None
        length = self._peek4()
        if length < 0 or length > MAX_FRAME or self._size - 4 < length:
            return None
        self._skip(4)
        return self._take(length)

    async def read4(self) -> Optional[bytes]:
        """The stream's next 4 bytes (a frame length — or a 4lw command).
        Always real ``bytes`` (callers test set membership)."""
        if not await self._need(4):
            return None
        out = self._take(4)
        return out if type(out) is bytes else bytes(out)

    async def frame(self, header: Optional[bytes] = None):
        """The next complete frame payload; None on EOF or bad length.

        ``header`` supplies a 4-byte length already consumed via
        :meth:`read4` (the server handshake peeks it to disambiguate
        4lw admin commands from the ConnectRequest frame).
        """
        if header is not None:
            length = int.from_bytes(header, "big", signed=True)
        else:
            if not await self._need(4):
                return None
            length = self._peek4()
            self._skip(4)
        if length < 0 or length > MAX_FRAME:
            malformed.note("zk_framing")
            return None
        if not await self._need(length):
            return None
        return self._take(length)
