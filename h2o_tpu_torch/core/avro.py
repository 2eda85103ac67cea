"""Port of ``h2o_tpu/core/avro.py``, copied:
the Avro container reader and writer.
The reference module imports no JAX; the port keeps its own copy, as
it imports nothing of ``h2o_tpu``.

First-party Avro Object Container File reader.

Reference: h2o-parsers/h2o-avro-parser (AvroParser.java) parses Avro
containers into frames.  No avro library is a dependency, so
this is a from-spec implementation of the container format
(https://avro.apache.org/docs/current/specification — stable, versioned)
covering what tabular ingest needs:

- header: magic ``Obj\\x01``, metadata map (``avro.schema`` JSON,
  ``avro.codec`` null/deflate), 16-byte sync marker;
- blocks: zigzag-varint count + byte size, raw-deflate payload,
  trailing sync marker;
- record schemas of primitive fields (null/boolean/int/long/float/
  double/string/bytes/enum) and the ubiquitous nullable union
  ``["null", T]`` — the shapes tabular writers emit.

Anything outside that (nested records, arrays, maps, fixed, recursive
unions) raises with the offending field named — same fail-loudly stance
as the rest of the ingest layer.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"Obj\x01"


class AvroError(ValueError):
    pass


class _Reader:
    def __init__(self, buf: bytes):
        self.b = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.b):
            raise AvroError("truncated avro data")
        out = self.b[self.pos: self.pos + n]
        self.pos += n
        return out

    def long(self) -> int:
        """Zigzag varint (spec: primitive long encoding)."""
        shift = 0
        acc = 0
        while True:
            byte = self.read(1)[0]
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
            if shift > 70:
                raise AvroError("varint too long")
        return (acc >> 1) ^ -(acc & 1)

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def boolean(self) -> bool:
        return self.read(1) != b"\x00"

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.b)


def _field_decoder(ftype, name: str):
    """Return (kind, fn(reader) -> python value) for a field schema.
    kind in {'num', 'str', 'enum:<symbols json>'}."""
    if isinstance(ftype, dict):
        t = ftype.get("type")
        logical = ftype.get("logicalType")
        if t == "enum":
            symbols = list(ftype.get("symbols") or [])

            def dec_enum(r: _Reader):
                i = r.long()
                if not 0 <= i < len(symbols):
                    raise AvroError(f"{name}: enum index {i} out of range")
                return symbols[i]
            return "enum", dec_enum
        if logical == "decimal":
            # two's-complement big-endian payloads are NOT text; decoding
            # them as UTF-8 would silently corrupt the column
            raise AvroError(f"field {name!r}: decimal logical type is "
                            "not supported (fixed-point bytes)")
        if logical in ("timestamp-millis", "timestamp-micros",
                       "date", "time-millis", "time-micros") and \
                t in ("int", "long"):
            scale = {"timestamp-millis": 1.0,
                     "timestamp-micros": 1e-3,
                     "date": 86400000.0,            # days -> ms
                     "time-millis": 1.0,
                     "time-micros": 1e-3}[logical]
            return "time", lambda r: float(r.long()) * scale
        # other logical types ride their primitive (uuid on string, ...)
        if isinstance(t, str):
            return _field_decoder(t, name)
        raise AvroError(f"field {name!r}: unsupported complex type "
                        f"{ftype.get('type')!r} (records of primitives "
                        "only)")
    if isinstance(ftype, list):
        # nullable union ["null", T] (either order)
        non_null = [t for t in ftype if t != "null"]
        if len(non_null) != 1 or len(ftype) > 2:
            raise AvroError(f"field {name!r}: only ['null', T] unions "
                            "are supported")
        null_idx = ftype.index("null")
        kind, inner = _field_decoder(non_null[0], name)

        def dec_union(r: _Reader):
            branch = r.long()
            if branch == null_idx:
                return None
            return inner(r)
        return kind, dec_union
    prim = {
        "null": ("num", lambda r: None),
        "boolean": ("num", lambda r: float(r.boolean())),
        "int": ("num", lambda r: float(r.long())),
        "long": ("num", lambda r: float(r.long())),
        "float": ("num", lambda r: r.float_()),
        "double": ("num", lambda r: r.double()),
        "string": ("str", lambda r: r.string()),
        "bytes": ("str", lambda r: r.bytes_().decode("utf-8",
                                                     "replace")),
    }
    if ftype not in prim:
        raise AvroError(f"field {name!r}: unsupported type {ftype!r}")
    return prim[ftype]


def _read_header(r: _Reader, path: str) -> Dict[str, bytes]:
    """Magic + zero-terminated metadata map (shared by the header-only
    and full readers)."""
    if r.read(4) != MAGIC:
        raise AvroError(f"{path} is not an Avro container (bad magic)")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:                       # negative count => byte size follows
            r.long()
            n = -n
        for _ in range(n):
            k = r.string()
            meta[k] = r.bytes_()
    if "avro.schema" not in meta:
        raise AvroError(f"{path}: header has no avro.schema")
    return meta


def read_avro_schema(path: str) -> Tuple[List[str], List[str]]:
    """Header-only parse -> (names, kinds); reads the header bytes,
    never the data blocks (the ParseSetup path)."""
    cap = 1 << 20
    while True:
        with open(path, "rb") as f:
            data = f.read(cap)
        try:
            meta = _read_header(_Reader(data), path)
            break
        except AvroError as e:
            # only truncation is fixable by reading more (pathological
            # >cap metadata); bad magic / missing schema are final
            import os as _os
            if "truncated" not in str(e) or \
                    cap >= _os.path.getsize(path):
                raise
            cap *= 8
    schema = json.loads(meta["avro.schema"])
    if schema.get("type") != "record":
        raise AvroError("top-level schema must be a record")
    names, kinds = [], []
    for f in schema.get("fields") or []:
        kind, _dec = _field_decoder(f["type"], f["name"])
        names.append(f["name"])
        kinds.append(kind)
    return names, kinds


def read_avro(path: str) -> Tuple[List[str], List[str],
                                  List[List[Any]]]:
    """Parse an Avro container -> (names, kinds, columns) with kinds in
    {'num','str','enum','time'} and columns as python lists (None = NA).
    'time' values are epoch milliseconds (timestamp/date logical
    types)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    meta = _read_header(r, path)
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"])
    codec = (meta.get("avro.codec") or b"null").decode()
    if codec not in ("null", "deflate"):
        raise AvroError(f"unsupported avro codec {codec!r}")
    if schema.get("type") != "record":
        raise AvroError("top-level schema must be a record")
    fields = schema.get("fields") or []
    names = [f["name"] for f in fields]
    decoders = []
    kinds = []
    for f in fields:
        kind, dec = _field_decoder(f["type"], f["name"])
        kinds.append(kind)
        decoders.append(dec)
    columns: List[List[Any]] = [[] for _ in names]
    while not r.eof:
        count = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, wbits=-15)   # raw deflate
        br = _Reader(block)
        for _ in range(count):
            for ci, dec in enumerate(decoders):
                columns[ci].append(dec(br))
        if r.read(16) != sync:
            raise AvroError("sync marker mismatch (corrupt container)")
    return names, kinds, columns


def write_avro(path: str, names: List[str], types: List[str],
               columns: List[List[Any]], codec: str = "deflate") -> str:
    """Minimal container writer (round-trip tests + frame export).
    types: 'num' -> nullable double, 'str'/'enum' -> nullable string."""
    def zig(n: int) -> bytes:
        u = (n << 1) ^ (n >> 63)
        out = bytearray()
        while True:
            b = u & 0x7F
            u >>= 7
            if u:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def put_bytes(b: bytes) -> bytes:
        return zig(len(b)) + b

    fields = [{"name": n,
               "type": ["null", "double" if t == "num" else "string"]}
              for n, t in zip(names, types)]
    schema = {"type": "record", "name": "h2o_tpu_frame",
              "fields": fields}
    body = io.BytesIO()
    nrows = len(columns[0]) if columns else 0
    for i in range(nrows):
        for t, col in zip(types, columns):
            v = col[i]
            is_na = v is None or (t == "num" and v != v)
            if is_na:
                body.write(zig(0))                  # union branch "null"
                continue
            body.write(zig(1))
            if t == "num":
                body.write(struct.pack("<d", float(v)))
            else:
                body.write(put_bytes(str(v).encode()))
    payload = body.getvalue()
    if codec == "deflate":
        co = zlib.compressobj(wbits=-15)
        payload = co.compress(payload) + co.flush()
    sync = b"h2o-tpu-sync-16b"
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(zig(2))
        f.write(put_bytes(b"avro.schema"))
        f.write(put_bytes(json.dumps(schema).encode()))
        f.write(put_bytes(b"avro.codec"))
        f.write(put_bytes(codec.encode()))
        f.write(zig(0))
        f.write(sync)
        if nrows:
            f.write(zig(nrows))
            f.write(zig(len(payload)))
            f.write(payload)
            f.write(sync)
    return path
