"""Streaming parse: incremental chunked CSV ingest — port of
``h2o_tpu/stream/ingest.py`` (``stream_chunk_rows``, ``last_record_end``,
``ChunkReader``, ``frame_from_chunk``).

The whole-file path (``core/parse.py``) reads a file in full.  Streaming
ingest keeps the same setup inference and the same byte tokenizer (the
native C++ loop, through ``parse.tokenize_chunk``) but reads the source
in bounded blocks and appends each block's columns to a growing host
Frame (``Frame.append_rows``: power-of-two buffers, no re-concatenation
of the accumulated columns).

CHUNK-BOUNDARY CORRECTNESS: a read block may end mid-record — including
inside a QUOTED field that itself contains newlines (or a CRLF split
between the CR and LF).  :func:`last_record_end` scans the buffered
bytes with quote-parity tracking and returns the end of the last
COMPLETE record; the tail is carried into the next block, so a chunked
parse is record-identical to the whole-file parse no matter where the
block boundaries fall.

RESILIENCE: every source read runs under the process retry policy
(``core/resilience.default_policy`` — backoff + deadline) with the
stream chaos injectors live (``H2O_TPU_CHAOS_STREAM_TRUNCATE[_TRANSIENT]``
raises a retryable truncation, ``H2O_TPU_CHAOS_STREAM_SLOW[_MS]`` stalls
the read), so a flaky tail -f-style source degrades to retries instead
of killing the pipeline.

FOLLOW MODE (unbounded sources): ``ChunkReader(follow=True)`` treats an
empty read as "no new data YET", re-polling the growing source every
``H2O_TPU_STREAM_POLL_MS`` instead of terminating.  ``stop()`` ends the
follow: the reader drains what is buffered and then reports exhaustion.
The reader tracks its exact BYTE CURSOR (``offset`` = bytes of the
source fully consumed into emitted chunks; the carry tail is not yet
consumed), and ``restore_cursor(offset)`` re-attaches a new reader at
that cursor, so a resumed stream neither repeats nor drops a record.
``emit_partial`` (default True) emits buffered complete records when
the source goes quiet — tail-f liveness; bitwise-replay harnesses set it
False so chunk boundaries depend only on byte content, never on poll
timing.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from h2o_tpu_torch.config import stream_poll_ms
from h2o_tpu_torch.core.frame import T_CAT, T_STR, T_TIME, Frame, Vec
from h2o_tpu_torch.core.log import get_logger
from h2o_tpu_torch.core.parse import (ParseSetupResult, localize,
                                      parse_setup, tokenize_chunk)
from h2o_tpu_torch.core.resilience import Deadline, default_policy

log = get_logger("stream")

# H2O_TPU_STREAM_CHUNK_ROWS: target rows per ingest chunk (the byte
# budget per read is derived from the sampled mean record length)
DEFAULT_CHUNK_ROWS = 4096


def stream_chunk_rows() -> int:
    return int(os.environ.get("H2O_TPU_STREAM_CHUNK_ROWS",
                              DEFAULT_CHUNK_ROWS) or DEFAULT_CHUNK_ROWS)


def last_record_end(buf: bytes, quote: int = 0x22) -> int:
    """Offset just past the LAST complete record in ``buf`` (0 when no
    record is complete yet).

    Quote parity: a newline inside an open quoted field is DATA, not a
    record boundary (an escaped ``""`` toggles parity twice, so it needs
    no special case).  A trailing ``\\r`` is kept with its record tail,
    so a CRLF split between blocks stitches correctly: the boundary is
    only ever declared after the ``\\n``.  (The reference scans byte by
    byte in Python; the parity here is a cumulative count, the same
    answer.)
    """
    b = np.frombuffer(buf, np.uint8)
    closed = (np.cumsum(b == quote) & 1) == 0
    ends = np.flatnonzero((b == 0x0A) & closed)
    return int(ends[-1]) + 1 if len(ends) else 0


class ChunkReader:
    """Incremental CSV reader: bounded byte blocks in, complete-record
    column chunks out.

    ``source`` is a local path / remote URI (fetched through the persist
    layer via ``localize``), an open binary file object, or an iterator
    of byte blocks (the test harness's split-sweep source).  ``setup``
    defaults to ``parse_setup`` inference on the source's head sample.
    ``deadline_secs`` bounds the TOTAL ingest wall clock (0 = unbounded).

    ``follow=True`` re-polls a source that returned no bytes (see the
    module docstring) every ``poll_ms`` until :meth:`stop`;
    ``emit_partial=False`` suppresses timing-dependent partial-chunk
    emission for bitwise replays.
    """

    def __init__(self, source, setup: Optional[ParseSetupResult] = None,
                 chunk_rows: Optional[int] = None,
                 chunk_bytes: Optional[int] = None,
                 deadline_secs: float = 0.0,
                 follow: bool = False,
                 poll_ms: Optional[float] = None,
                 emit_partial: bool = True):
        self.follow = bool(follow)
        self.emit_partial = bool(emit_partial)
        self._poll_s = (poll_ms if poll_ms is not None
                        else stream_poll_ms()) / 1000.0
        self._stop = threading.Event()
        self._carry = b""
        self._eof = False
        self._first = True
        self.chunks_read = 0
        self.rows_read = 0
        # byte cursor: _read_pos counts every byte pulled off the
        # source; offset (== _read_pos - len(_carry)) is the resume
        # point — everything before it has been emitted in a chunk
        self._read_pos = 0
        self.deadline = Deadline(deadline_secs)
        self._iter: Optional[Iterator[bytes]] = None
        self._fobj = None
        if isinstance(source, (str, os.PathLike)):
            self.name = str(source)
            self._fobj = open(localize(str(source)), "rb")
        elif hasattr(source, "read"):
            self.name = getattr(source, "name", "<stream>")
            self._fobj = source
        else:
            self.name = "<blocks>"
            self._iter = iter(source)
        self.setup = setup if setup is not None else self._sniff_setup()
        rows = int(chunk_rows or stream_chunk_rows())
        if chunk_bytes is not None:
            self.chunk_bytes = int(chunk_bytes)
        else:
            # byte budget from the sampled mean record length so a chunk
            # lands ~chunk_rows rows (exact row counts do not matter —
            # the append path buckets them anyway)
            sample = self._peek()
            recs = max(sample.count(b"\n"), 1)
            self.chunk_bytes = max(
                256, rows * max(len(sample) // recs, 8))

    # -- source plumbing -----------------------------------------------------

    def _peek(self, n: int = 65536) -> bytes:
        """Buffer up to ``n`` bytes into the carry (setup sniffing /
        record-length estimation) without consuming records."""
        while len(self._carry) < n and not self._eof:
            block = self._read_block(n - len(self._carry))
            if not block:
                break
            self._carry += block
        return self._carry

    def _sniff_setup(self) -> ParseSetupResult:
        import tempfile
        head = self._peek()
        if not head:
            raise ValueError(f"empty stream source: {self.name}")
        fd, tmp = tempfile.mkstemp(suffix=".csv")
        try:
            with os.fdopen(fd, "wb") as f:
                # sniff only complete lines (a torn tail token would
                # corrupt type inference)
                f.write(head[: last_record_end(head) or len(head)])
            return parse_setup([tmp])
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _read_block(self, n: int) -> bytes:
        """One source read under the retry policy with the stream chaos
        injectors live — a truncated/flaky source retries with backoff
        instead of failing the pipeline."""
        def attempt() -> bytes:
            from h2o_tpu_torch.core.chaos import chaos
            c = chaos()
            if c.enabled:
                c.maybe_slow_stream(self.name)
                c.maybe_truncate_stream(self.name)
            if self._fobj is not None:
                return self._fobj.read(n)
            try:
                return next(self._iter)
            except StopIteration:
                return b""

        data = default_policy().call(
            attempt, what=f"stream read {self.name}",
            deadline=self.deadline if self.deadline.seconds else None)
        if not data:
            # follow mode: an empty read means "no new data YET", not
            # end-of-stream — unless the follow was stopped, which
            # turns the next empty read into the drain signal
            if not self.follow or self._stop.is_set():
                self._eof = True
        else:
            self._read_pos += len(data)
        return data or b""

    # -- follow-mode cursor API ----------------------------------------------

    @property
    def offset(self) -> int:
        """Byte offset of the first UNEMITTED record — the durable
        resume cursor (everything before it landed in a chunk)."""
        return self._read_pos - len(self._carry)

    @property
    def exhausted(self) -> bool:
        """True once the source ended (or the follow was stopped) AND
        the buffered tail has drained."""
        return self._eof and not self._carry

    def stop(self) -> None:
        """End a follow: the next empty read becomes end-of-stream, the
        buffered records drain, and any poll sleep wakes immediately."""
        self._stop.set()

    def restore_cursor(self, offset: int, chunks_read: int = 0,
                       rows_read: int = 0) -> None:
        """Re-attach at a persisted byte cursor (seekable sources only):
        drop the buffered carry, seek, and restore the counters — the
        recovery half of the durable-cursor contract.  A mid-file
        cursor implies the header row was already consumed."""
        if self._fobj is None or not hasattr(self._fobj, "seek"):
            raise ValueError(
                f"cursor restore requires a seekable source ({self.name})")
        self._fobj.seek(int(offset))
        self._carry = b""
        self._read_pos = int(offset)
        self._eof = False
        self._first = offset == 0
        self.chunks_read = int(chunks_read)
        self.rows_read = int(rows_read)

    # -- chunk iteration -----------------------------------------------------

    def next_chunk(self, wait: bool = True) -> Optional[Dict[str, object]]:
        """The next chunk of COMPLETE records as host column payloads
        (``Frame.append_rows`` shape), or None at end of stream.

        Follow mode: with ``wait=True`` (default) a quiet source blocks,
        re-polling until data arrives or :meth:`stop`; ``wait=False``
        returns None immediately when nothing is buffered (check
        :attr:`exhausted` to distinguish "idle" from "ended" — the
        multi-source pipeline round-robins this way)."""
        self.deadline.check(f"stream ingest {self.name}")
        records = b""
        while True:
            if self._carry and (self._eof or
                                len(self._carry) >= self.chunk_bytes):
                # bound the chunk at chunk_bytes, backing up to the last
                # complete record; a single record longer than the
                # window (one huge quoted field) widens to the full
                # carry before giving up and reading more
                window = self._carry[: self.chunk_bytes]
                end = last_record_end(window)
                if end == 0:
                    end = last_record_end(self._carry)
                if end > 0:
                    records = self._carry[:end]
                    self._carry = self._carry[end:]
                    break
            if self._eof:
                # torn tail: the final record may lack its newline
                records, self._carry = self._carry, b""
                break
            block = self._read_block(self.chunk_bytes)
            if block:
                self._carry += block
                continue
            if self._eof:
                continue                 # drain what is buffered
            # follow mode, source quiet: emit buffered complete records
            # (tail-f liveness) unless the replay harness opted out
            if self.emit_partial and self._carry:
                end = last_record_end(self._carry)
                if end > 0:
                    records = self._carry[:end]
                    self._carry = self._carry[end:]
                    break
            if not wait:
                return None
            self._stop.wait(self._poll_s)
        if not records.strip():
            return None
        header = self._first and self.setup.header
        self._first = False
        cols = tokenize_chunk(records, self.setup, header=header)
        n = _chunk_len(cols)
        self.chunks_read += 1
        self.rows_read += n
        log.debug("stream %s: chunk %d (%d rows, %d bytes carried)",
                  self.name, self.chunks_read, n, len(self._carry))
        return cols

    def __iter__(self):
        while True:
            c = self.next_chunk()
            if c is None:
                return
            yield c

    def close(self) -> None:
        self._stop.set()
        if self._fobj is not None:
            try:
                self._fobj.close()
            except OSError:
                pass


def _chunk_len(cols: Dict[str, object]) -> int:
    for payload in cols.values():
        vals = payload[0] if isinstance(payload, tuple) else payload
        return len(vals)
    return 0


def frame_from_chunk(cols: Dict[str, object],
                     setup: ParseSetupResult) -> Frame:
    """The frame the first chunk starts and the later chunks grow
    (``Frame.append_rows``), columns in the setup's order; it stays on
    the host."""
    names, vecs = [], []
    for name, t in zip(setup.column_names, setup.column_types):
        payload = cols[name]
        names.append(name)
        if t == T_CAT:
            codes, domain = payload
            vecs.append(Vec(np.asarray(codes, np.int32), T_CAT,
                            domain=list(domain)))
        elif t == T_STR:
            vecs.append(Vec(list(payload), T_STR))
        elif t == T_TIME:
            vecs.append(Vec(np.asarray(payload, np.float64), T_TIME))
        else:
            vecs.append(Vec(np.asarray(payload, np.float32)))
    return Frame(names, vecs)
