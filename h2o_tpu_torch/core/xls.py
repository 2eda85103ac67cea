"""Port of ``h2o_tpu/core/xls.py``, copied:
the XLS/XLSX first-sheet readers.
The reference module imports no JAX; the port keeps its own copy, as
it imports nothing of ``h2o_tpu``.

First-party XLS/XLSX ingest.

Reference: water/parser/XlsParser.java — a from-scratch BIFF record
reader (the reference likewise ships its own, no POI).  Here both
spreadsheet generations are read with the stdlib only:

- ``.xlsx`` (SpreadsheetML): a zip of XML — sharedStrings + the first
  worksheet's cell grid via xml.etree;
- ``.xls`` (BIFF8 in an OLE2 compound document): the compound-file FAT /
  miniFAT is walked to the ``Workbook`` stream, then BIFF cell records
  (NUMBER / RK / MULRK / LABELSST / LABEL / BOOLERR) are decoded.

The decoded grid is handed to the CSV ingest path for type inference,
NA handling and domain building — one set of parse semantics for every
format (core/parse.py).  Date cells surface as Excel serial numbers
(the reference's XlsParser has the same limitation).
"""

from __future__ import annotations

import re
import struct
import zipfile
from typing import List, Optional
from xml.etree import ElementTree as ET


# ---------------------------------------------------------------------------
# xlsx (SpreadsheetML)
# ---------------------------------------------------------------------------

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(ref: str) -> int:
    """'BC12' -> zero-based column index of 'BC'."""
    n = 0
    for ch in ref:
        if not ch.isalpha():
            break
        n = n * 26 + (ord(ch.upper()) - ord("A") + 1)
    return n - 1


_REL_NS = ("{http://schemas.openxmlformats.org/package/2006/"
           "relationships}")


def _first_sheet_part(z: zipfile.ZipFile) -> Optional[str]:
    """The FIRST sheet in TAB order: workbook.xml's <sheets> sequence
    resolved through workbook.xml.rels (part filenames do not track tab
    order after reordering); lexicographic sheetN.xml is the fallback
    for minimal writers that omit the workbook parts."""
    names = set(z.namelist())
    if "xl/workbook.xml" in names and \
            "xl/_rels/workbook.xml.rels" in names:
        try:
            wb = ET.fromstring(z.read("xl/workbook.xml"))
            rid = None
            for sh in wb.iter(f"{_NS}sheet"):
                rid = next((v for k, v in sh.attrib.items()
                            if k.endswith("}id") or k == "id"), None)
                break
            rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
            for rel in rels.iter(f"{_REL_NS}Relationship"):
                if rel.get("Id") == rid:
                    tgt = rel.get("Target", "").lstrip("/")
                    cand = tgt if tgt.startswith("xl/") else f"xl/{tgt}"
                    if cand in names:
                        return cand
        except ET.ParseError:
            pass
    return next((n for n in sorted(names)
                 if re.fullmatch(r"xl/worksheets/sheet\d+\.xml", n)),
                None)


def read_xlsx(path: str) -> List[List[Optional[str]]]:
    """First worksheet (tab order) -> rows of cell strings (None =
    empty)."""
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                shared.append("".join(t.text or ""
                                      for t in si.iter(f"{_NS}t")))
        sheet_name = _first_sheet_part(z)
        if sheet_name is None:
            raise ValueError(f"{path}: no worksheet found")
        root = ET.fromstring(z.read(sheet_name))
        rows: List[List[Optional[str]]] = []
        for row in root.iter(f"{_NS}row"):
            cells: List[Optional[str]] = []
            for c in row.findall(f"{_NS}c"):
                idx = _col_index(c.get("r", ""))
                if idx < 0:
                    idx = len(cells)
                while len(cells) <= idx:
                    cells.append(None)
                t = c.get("t", "n")
                v = c.find(f"{_NS}v")
                if t == "inlineStr":
                    is_ = c.find(f"{_NS}is")
                    cells[idx] = "".join(
                        tt.text or "" for tt in is_.iter(f"{_NS}t")) \
                        if is_ is not None else None
                elif v is None or v.text is None:
                    cells[idx] = None
                elif t == "s":
                    cells[idx] = shared[int(v.text)]
                elif t == "b":
                    cells[idx] = "true" if v.text == "1" else "false"
                else:                       # n / str / e
                    cells[idx] = v.text
            rows.append(cells)
        return rows


# ---------------------------------------------------------------------------
# xls (OLE2 compound document + BIFF8)
# ---------------------------------------------------------------------------

_OLE_MAGIC = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
_FREESECT = 0xFFFFFFFF
_ENDOFCHAIN = 0xFFFFFFFE


def _ole_stream(data: bytes, want=("Workbook", "Book")) -> bytes:
    """Extract a named stream from an OLE2 compound document."""
    if data[:8] != _OLE_MAGIC:
        raise ValueError("not an OLE2 compound document")
    sect_size = 1 << struct.unpack_from("<H", data, 30)[0]
    mini_size = 1 << struct.unpack_from("<H", data, 32)[0]
    n_fat = struct.unpack_from("<I", data, 44)[0]
    dir_start = struct.unpack_from("<I", data, 48)[0]
    mini_cutoff = struct.unpack_from("<I", data, 56)[0]
    minifat_start = struct.unpack_from("<I", data, 60)[0]
    difat_start = struct.unpack_from("<I", data, 68)[0]
    n_difat = struct.unpack_from("<I", data, 72)[0]

    def sector(i: int) -> bytes:
        off = 512 + i * sect_size
        return data[off: off + sect_size]

    # FAT sector list: 109 header DIFAT entries + chained DIFAT sectors
    fat_sectors = list(struct.unpack_from("<109I", data, 76))
    ds = difat_start
    for _ in range(n_difat):
        if ds in (_FREESECT, _ENDOFCHAIN):
            break
        blk = sector(ds)
        fat_sectors += struct.unpack_from(
            f"<{sect_size // 4 - 1}I", blk, 0)
        ds = struct.unpack_from("<I", blk, sect_size - 4)[0]
    fat: List[int] = []
    for si in fat_sectors[:n_fat]:
        if si in (_FREESECT, _ENDOFCHAIN):
            continue
        fat += struct.unpack_from(f"<{sect_size // 4}I", sector(si))

    def chain(start: int) -> bytes:
        out, s, guard = [], start, 0
        while s not in (_ENDOFCHAIN, _FREESECT) and guard <= len(fat):
            out.append(sector(s))
            s = fat[s]
            guard += 1
        return b"".join(out)

    directory = chain(dir_start)
    entries = []
    for off in range(0, len(directory) - 127, 128):
        name_len = struct.unpack_from("<H", directory, off + 64)[0]
        name = directory[off: off + max(name_len - 2, 0)] \
            .decode("utf-16-le", "ignore")
        start = struct.unpack_from("<I", directory, off + 116)[0]
        size = struct.unpack_from("<I", directory, off + 120)[0]
        entries.append((name, start, size))
    root_start = entries[0][1] if entries else _ENDOFCHAIN
    mini_container = chain(root_start) if root_start not in (
        _ENDOFCHAIN, _FREESECT) else b""
    minifat: List[int] = []
    if minifat_start not in (_ENDOFCHAIN, _FREESECT):
        mf = chain(minifat_start)
        minifat = list(struct.unpack_from(f"<{len(mf) // 4}I", mf))

    for name, start, size in entries:
        if name not in want:
            continue
        if size < mini_cutoff:
            out, s, guard = [], start, 0
            while s not in (_ENDOFCHAIN, _FREESECT) and \
                    guard <= len(minifat):
                out.append(mini_container[s * mini_size:
                                          (s + 1) * mini_size])
                s = minifat[s]
                guard += 1
            return b"".join(out)[:size]
        return chain(start)[:size]
    raise ValueError("no Workbook stream in .xls file")


def _rk_value(rk: int) -> float:
    if rk & 2:                              # 30-bit signed integer
        v = rk >> 2
        if v & 0x20000000:                  # sign-extend
            v -= 0x40000000
        v = float(v)
    else:                                   # top 30 bits of a double
        bits = (rk & 0xFFFFFFFC) << 32
        v = struct.unpack("<d", struct.pack("<Q", bits))[0]
    return v / 100.0 if rk & 1 else v


def _biff_string(buf: bytes, off: int):
    """XLUnicodeRichExtendedString -> (text, bytes consumed)."""
    cch = struct.unpack_from("<H", buf, off)[0]
    flags = buf[off + 2]
    pos = off + 3
    n_runs = 0
    ext = 0
    if flags & 0x08:
        n_runs = struct.unpack_from("<H", buf, pos)[0]
        pos += 2
    if flags & 0x04:
        ext = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
    if flags & 0x01:
        text = buf[pos: pos + 2 * cch].decode("utf-16-le", "ignore")
        pos += 2 * cch
    else:
        text = buf[pos: pos + cch].decode("latin-1")
        pos += cch
    pos += 4 * n_runs + ext
    return text, pos - off


class _SSTCursor:
    """Reads the SST's logical byte stream across CONTINUE segments.

    MS-XLS 2.5.293: a string may split only at a character boundary,
    and the continued character data starts with a fresh option-flags
    byte that re-declares the width (compressed/UTF-16) of the
    remainder; non-character data (headers, format runs, ext blocks)
    continues byte-for-byte without one."""

    def __init__(self, segments: List[bytes]):
        self._segs = segments
        self._si = 0
        self._off = 0

    def _norm(self):
        while self._si < len(self._segs) and \
                self._off >= len(self._segs[self._si]):
            self._si += 1
            self._off = 0

    def eof(self) -> bool:
        self._norm()
        return self._si >= len(self._segs)

    def read(self, n: int) -> bytes:
        out = []
        while n > 0:
            if self.eof():
                raise ValueError("SST truncated mid-record")
            seg = self._segs[self._si]
            take = min(n, len(seg) - self._off)
            out.append(seg[self._off: self._off + take])
            self._off += take
            n -= take
        return b"".join(out)

    def read_chars(self, cch: int, high: int) -> str:
        text = []
        seg_of_header = self._si
        while cch > 0:
            self._norm()
            if self.eof():
                raise ValueError("SST truncated mid-string")
            if self._si != seg_of_header:
                # character data resumes (or begins — the header can end
                # exactly at a record boundary) in a continuation
                # segment: it starts with a fresh option-flags byte
                high = self._segs[self._si][self._off] & 0x01
                self._off += 1
                seg_of_header = self._si
                continue
            seg = self._segs[self._si]
            avail = len(seg) - self._off
            width = 2 if high else 1
            take = min(cch, avail // width)
            if take == 0:
                if avail:
                    raise ValueError("SST split inside a character")
                continue               # segment exhausted: _norm + flags
            raw = seg[self._off: self._off + take * width]
            text.append(raw.decode("utf-16-le" if high else "latin-1",
                                   "ignore"))
            self._off += take * width
            cch -= take
        return "".join(text)


def _parse_sst(segments: List[bytes], total: int) -> List[str]:
    """SST body segments (SST record tail + CONTINUE bodies) -> strings.

    Raises instead of returning a short table: a silently-truncated SST
    would null out LABELSST cells downstream."""
    cur = _SSTCursor(segments)
    sst: List[str] = []
    while len(sst) < total and not cur.eof():
        cch = struct.unpack("<H", cur.read(2))[0]
        flags = cur.read(1)[0]
        n_runs = struct.unpack("<H", cur.read(2))[0] \
            if flags & 0x08 else 0
        ext = struct.unpack("<i", cur.read(4))[0] if flags & 0x04 else 0
        sst.append(cur.read_chars(cch, flags & 0x01))
        cur.read(4 * n_runs + max(ext, 0))   # format runs + ext block
    if len(sst) < total:
        raise ValueError(
            f"SST declares {total} strings but only {len(sst)} decoded "
            "— refusing to produce silently-nulled string cells")
    return sst


def read_xls(path: str) -> List[List[Optional[str]]]:
    """BIFF8 Workbook stream -> rows of cell strings (first sheet)."""
    with open(path, "rb") as f:
        data = f.read()
    stream = _ole_stream(data)
    # one linear pass: collect SST, then cell records of the first sheet
    sst: List[str] = []
    cells = {}
    pos = 0
    sheets_seen = 0
    while pos + 4 <= len(stream):
        op, ln = struct.unpack_from("<HH", stream, pos)
        body = stream[pos + 4: pos + 4 + ln]
        pos += 4 + ln
        if op == 0x0809:                    # BOF
            sheets_seen += 1
            if sheets_seen > 2:             # globals + first sheet only
                break
        elif op == 0x00FC:                  # SST (+ its CONTINUEs)
            total = struct.unpack_from("<I", body, 4)[0]
            segments = [bytes(body[8:])]
            while pos + 4 <= len(stream):
                nop, nln = struct.unpack_from("<HH", stream, pos)
                if nop != 0x003C:           # CONTINUE
                    break
                segments.append(bytes(stream[pos + 4: pos + 4 + nln]))
                pos += 4 + nln
            sst = _parse_sst(segments, total)
        elif op == 0x00FD and sheets_seen == 2:       # LABELSST
            r, c, _xf, isst = struct.unpack_from("<HHHI", body)
            cells[(r, c)] = sst[isst] if isst < len(sst) else None
        elif op == 0x0203 and sheets_seen == 2:       # NUMBER
            r, c, _xf = struct.unpack_from("<HHH", body)
            cells[(r, c)] = repr(struct.unpack_from("<d", body, 6)[0])
        elif op == 0x027E and sheets_seen == 2:       # RK
            r, c, _xf, rk = struct.unpack_from("<HHHI", body)
            cells[(r, c)] = repr(_rk_value(rk))
        elif op == 0x00BD and sheets_seen == 2:       # MULRK
            r, c0 = struct.unpack_from("<HH", body)
            n = (len(body) - 6) // 6
            for i in range(n):
                rk = struct.unpack_from("<I", body, 4 + 6 * i + 2)[0]
                cells[(r, c0 + i)] = repr(_rk_value(rk))
        elif op == 0x0204 and sheets_seen == 2:       # LABEL (BIFF8)
            r, c, _xf = struct.unpack_from("<HHH", body)
            s, _ = _biff_string(body, 6)
            cells[(r, c)] = s
        elif op == 0x0205 and sheets_seen == 2:       # BOOLERR
            r, c, _xf, v, is_err = struct.unpack_from("<HHHBB", body)
            cells[(r, c)] = None if is_err else \
                ("true" if v else "false")
    if not cells:
        return []
    n_rows = max(r for r, _ in cells) + 1
    n_cols = max(c for _, c in cells) + 1
    return [[cells.get((r, c)) for c in range(n_cols)]
            for r in range(n_rows)]


def rows_to_csv(rows: List[List[Optional[str]]]) -> str:
    """Decoded grid -> CSV text for the shared ingest path."""
    import csv
    import io
    buf = io.StringIO()
    w = csv.writer(buf)
    width = max((len(r) for r in rows), default=0)
    for r in rows:
        w.writerow([("" if v is None else v) for v in
                    (list(r) + [None] * (width - len(r)))])
    return buf.getvalue()
