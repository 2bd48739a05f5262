"""Minimal reader for legacy Excel 97-2003 ``.xls`` files (OLE2 compound
file + BIFF8 worksheet records): this package's own copy of
:mod:`vbhem_tpu.utils.xls`, pure Python, so it runs where neither JAX nor
pandas is installed.

The reference ingests data with `src/util/read_xls_fixations.m`, and its
shipped dataset `demo/demodata.xls` is a legacy BIFF8 workbook.  pandas
needs the optional ``xlrd`` package for that format, so this module
implements the small subset of OLE2 + BIFF8 needed to read plain tabular
sheets (numbers + shared strings).

Scope (deliberate): single values per cell via NUMBER / RK / MULRK /
LABELSST / LABEL / BOOLERR / FORMULA-cached-number records; shared
string table with CONTINUE spanning; first worksheet only.  No styles,
no dates-as-dates (dates surface as raw serial numbers), no charts.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple, Union

Cell = Union[float, str, bool, None]

_FREESECT = -1
_ENDOFCHAIN = -2

# ---------------------------------------------------------------------------
# OLE2 compound file


def _ole_stream(data: bytes, names=("Workbook", "Book")) -> bytes:
    """Extract a named stream from an OLE2 compound file."""
    if data[:8] != b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        raise ValueError("not an OLE2 compound file (bad magic)")
    sect_size = 1 << struct.unpack("<H", data[30:32])[0]
    mini_size = 1 << struct.unpack("<H", data[32:34])[0]
    n_fat = struct.unpack("<i", data[44:48])[0]
    dir_start = struct.unpack("<i", data[48:52])[0]
    mini_cutoff = struct.unpack("<i", data[56:60])[0]
    minifat_start = struct.unpack("<i", data[60:64])[0]
    n_minifat = struct.unpack("<i", data[64:68])[0]
    difat_start = struct.unpack("<i", data[68:72])[0]
    n_difat = struct.unpack("<i", data[72:76])[0]

    def sector(i: int) -> bytes:
        off = 512 + i * sect_size
        return data[off:off + sect_size]

    # FAT sector list: 109 entries in the header, then DIFAT chain.
    difat: List[int] = list(struct.unpack("<109i", data[76:512]))
    s = difat_start
    for _ in range(max(n_difat, 0)):
        if s < 0:
            break
        raw = struct.unpack(f"<{sect_size // 4}i", sector(s))
        difat.extend(raw[:-1])
        s = raw[-1]
    fat: List[int] = []
    per = sect_size // 4
    for fs in difat:
        if fs >= 0 and len(fat) < n_fat * per:
            fat.extend(struct.unpack(f"<{per}i", sector(fs)))

    def chain(start: int, limit: Optional[int] = None) -> bytes:
        out, seen, s = [], set(), start
        while s >= 0 and s not in seen and s < len(fat):
            seen.add(s)
            out.append(sector(s))
            s = fat[s]
        buf = b"".join(out)
        return buf if limit is None else buf[:limit]

    # Directory entries (128 bytes each).
    dirdata = chain(dir_start)
    root_start = root_size = None
    target = None
    for off in range(0, len(dirdata), 128):
        e = dirdata[off:off + 128]
        if len(e) < 128:
            break
        nlen = struct.unpack("<H", e[64:66])[0]
        if nlen < 2:
            continue
        name = e[:nlen - 2].decode("utf-16le", "replace")
        typ = e[66]
        start = struct.unpack("<i", e[116:120])[0]
        size = struct.unpack("<I", e[120:124])[0]
        if typ == 5:  # root entry carries the mini stream
            root_start, root_size = start, size
        elif typ == 2 and name in names and target is None:
            target = (start, size)
    if target is None:
        raise ValueError(f"no {names} stream in file")
    start, size = target
    if size >= mini_cutoff:
        return chain(start, size)

    # Small stream: follow the miniFAT within the root mini stream.
    mini_stream = chain(root_start, root_size)
    minifat: List[int] = []
    s = minifat_start
    for _ in range(max(n_minifat, 0)):
        if s < 0:
            break
        minifat.extend(struct.unpack(f"<{per}i", sector(s)))
        s = fat[s] if s < len(fat) else _ENDOFCHAIN
    out, seen, s = [], set(), start
    while s >= 0 and s not in seen and s < len(minifat):
        seen.add(s)
        out.append(mini_stream[s * mini_size:(s + 1) * mini_size])
        s = minifat[s]
    return b"".join(out)[:size]


# ---------------------------------------------------------------------------
# BIFF8 records


def _records(stream: bytes):
    pos = 0
    while pos + 4 <= len(stream):
        op, ln = struct.unpack("<HH", stream[pos:pos + 4])
        if op == 0:
            return
        yield op, stream[pos + 4:pos + 4 + ln]
        pos += 4 + ln


def _decode_rk(rk: int) -> float:
    if rk & 0x02:  # integer payload: arithmetic shift of signed 32-bit
        v = float((rk - (1 << 32) if rk & 0x80000000 else rk) >> 2)
    else:  # top 30 bits of an IEEE double
        v = struct.unpack("<d", struct.pack("<I", 0) +
                          struct.pack("<I", rk & 0xFFFFFFFC))[0]
    return v / 100.0 if rk & 0x01 else v


def _parse_sst(chunks: List[bytes]) -> List[str]:
    """Shared string table, possibly spanning CONTINUE records.

    Where a string's characters go on in the next record, that record
    starts with a fresh option byte, which says whether they go on as
    latin-1 or as UTF-16 ([MS-XLS] 2.5.293 XLUnicodeRichExtendedString);
    rich-text runs and extended data that go on carry none.
    """
    strings: List[str] = []
    ci, pos = 0, 8  # skip cstTotal/cstUnique
    n_unique = struct.unpack("<i", chunks[0][4:8])[0]

    def avail() -> int:
        return len(chunks[ci]) - pos

    def advance():
        nonlocal ci, pos
        while ci < len(chunks) and pos >= len(chunks[ci]):
            ci += 1
            pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        advance()
        b = chunks[ci][pos:pos + n]
        pos += n
        if len(b) != n:
            raise ValueError("SST truncated")
        return b

    for _ in range(n_unique):
        advance()
        cch = struct.unpack("<H", take(2))[0]
        grbit = take(1)[0]
        n_runs = struct.unpack("<H", take(2))[0] if grbit & 0x08 else 0
        cb_ext = struct.unpack("<i", take(4))[0] if grbit & 0x04 else 0
        parts: List[str] = []
        remaining = cch
        high = bool(grbit & 0x01)
        while remaining:
            width = 2 if high else 1
            n_here = min(remaining, avail() // width)
            if n_here == 0:
                # the characters go on in the next record, after its
                # option byte
                ci += 1
                if ci >= len(chunks) or not chunks[ci]:
                    raise ValueError("SST truncated")
                high = bool(chunks[ci][0] & 0x01)
                pos = 1
                continue
            raw = take(n_here * width)
            parts.append(raw.decode("utf-16le" if high else "latin-1"))
            remaining -= n_here
        # rich-text runs and extended data may also span records
        skip = 4 * n_runs + cb_ext
        while skip:
            advance()
            n_here = min(skip, avail())
            if n_here == 0:
                ci += 1
                pos = 0
                continue
            take(n_here)
            skip -= n_here
        strings.append("".join(parts))
    return strings


def read_xls_cells(path: str) -> Dict[Tuple[int, int], Cell]:
    """All cells of the FIRST worksheet as {(row, col): value}."""
    with open(path, "rb") as f:
        data = f.read()
    stream = _ole_stream(data)

    # Gather SST (+ its CONTINUEs) from the workbook-globals substream.
    recs = list(_records(stream))
    sst: List[str] = []
    for i, (op, body) in enumerate(recs):
        if op == 0x00FC:  # SST
            chunks = [body]
            for op2, body2 in recs[i + 1:]:
                if op2 != 0x003C:  # CONTINUE
                    break
                chunks.append(body2)
            sst = _parse_sst(chunks)
            break

    cells: Dict[Tuple[int, int], Cell] = {}
    sheet_idx = -1  # workbook globals come first
    for op, body in recs:
        if op == 0x0809:  # BOF
            sheet_idx += 1
            continue
        if sheet_idx != 1:  # first worksheet substream only
            continue
        if op == 0x0203:  # NUMBER
            r, c = struct.unpack("<HH", body[:4])
            cells[(r, c)] = struct.unpack("<d", body[6:14])[0]
        elif op == 0x027E:  # RK
            r, c = struct.unpack("<HH", body[:4])
            cells[(r, c)] = _decode_rk(
                struct.unpack("<I", body[6:10])[0])
        elif op == 0x00BD:  # MULRK
            r, c0 = struct.unpack("<HH", body[:4])
            n = (len(body) - 6) // 6
            for k in range(n):
                rk = struct.unpack("<I", body[4 + 6 * k + 2:
                                              4 + 6 * k + 6])[0]
                cells[(r, c0 + k)] = _decode_rk(rk)
        elif op == 0x00FD:  # LABELSST
            r, c = struct.unpack("<HH", body[:4])
            idx = struct.unpack("<I", body[6:10])[0]
            cells[(r, c)] = sst[idx] if idx < len(sst) else ""
        elif op == 0x0204:  # LABEL (inline string)
            r, c = struct.unpack("<HH", body[:4])
            cch = struct.unpack("<H", body[6:8])[0]
            high = body[8] & 0x01
            raw = body[9:9 + cch * (2 if high else 1)]
            cells[(r, c)] = raw.decode("utf-16le" if high else "latin-1")
        elif op == 0x0205:  # BOOLERR
            r, c = struct.unpack("<HH", body[:4])
            if body[7] == 0:  # bool (not error)
                cells[(r, c)] = bool(body[6])
        elif op == 0x0006:  # FORMULA — cached numeric result only
            r, c = struct.unpack("<HH", body[:4])
            res = body[6:14]
            if res[6:8] != b"\xff\xff":
                cells[(r, c)] = struct.unpack("<d", res)[0]
    return cells


def read_xls_table(path: str) -> Tuple[List[str], List[List[Cell]]]:
    """First worksheet as (header, rows): header = first non-empty row
    (stringified), rows = the remaining rows in order, rectangularized
    over the header's columns."""
    cells = read_xls_cells(path)
    if not cells:
        return [], []
    rows = sorted({r for r, _ in cells})
    hdr_r = rows[0]
    hdr_cols = sorted(c for (r, c) in cells if r == hdr_r)
    header = [str(cells[(hdr_r, c)]) for c in hdr_cols]
    out = [[cells.get((r, c)) for c in hdr_cols]
           for r in rows[1:]]
    return header, out
