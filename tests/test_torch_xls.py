"""The BIFF8 shared string table reader of the port
(``vbhem_tpu_torch.utils.xls._parse_sst``) on strings whose characters
go on in a CONTINUE record.  Each such record starts with an option byte
that says whether the characters go on as latin-1 or as UTF-16 ([MS-XLS]
2.5.293); rich-text runs and extended data that go on carry none.  The
JAX package's reader decodes that option byte as text where the first
record ends on a whole character, so it is no oracle here: the tests
hold the reader to the strings they encode."""
import struct

import pytest

from vbhem_tpu_torch.utils import xls


def header(n):
    return struct.pack("<ii", n, n)


def chars(text, high):
    return text.encode("utf-16le" if high else "latin-1")


def string_head(text, high, runs=0, ext=0):
    """cch, the option byte and, where present, the run and ext counts."""
    grbit = int(high) | (0x08 if runs else 0) | (0x04 if ext else 0)
    out = struct.pack("<HB", len(text), grbit)
    if runs:
        out += struct.pack("<H", runs)
    if ext:
        out += struct.pack("<i", ext)
    return out


def split_table(first, second, runs=0):
    """An SST of "ID", a string whose first 3 characters are in the first
    record (``first``: UTF-16 or not) and the rest, after the option byte,
    in a CONTINUE record (``second``), then "end"; ``runs`` rich-text
    runs (4 bytes each) after the split string's characters, in the
    CONTINUE record with no option byte."""
    text = "Fix" + ("é!Ω" if second else "é!z")
    head = header(3) + string_head("ID", False) + chars("ID", False)
    rec1 = head + string_head(text, first, runs) + chars(text[:3], first)
    rec2 = (bytes([int(second)]) + chars(text[3:], second)
            + b"\x01\x00\x02\x00" * runs
            + string_head("end", False) + chars("end", False))
    return [rec1, rec2], ["ID", text, "end"]


@pytest.mark.parametrize("first,second,runs", [
    (False, True, 0),    # latin-1, then UTF-16
    (True, False, 0),    # UTF-16, then latin-1
    (False, False, 0),   # latin-1 on both sides of the record's end
    (True, True, 0),
    (False, True, 2),    # with rich-text runs after the characters
    (True, False, 1),
])
def test_split_string_reads_the_continuation_option_byte(first, second,
                                                         runs):
    """The first record ends on a whole character; the reader takes the
    next record's first byte as its option byte, not as a character."""
    chunks, want = split_table(first, second, runs)
    assert len(chunks[0]) - 8 > 0
    assert xls._parse_sst(chunks) == want


def test_header_at_a_record_end():
    """A string whose header ends a record: its characters start after the
    next record's option byte."""
    rec1 = header(2) + string_head("abc", True)
    rec2 = b"\x00" + b"abc" + string_head("z", False) + b"z"
    assert xls._parse_sst([rec1, rec2]) == ["abc", "z"]


def test_truncated_continuation_raises():
    chunks, _ = split_table(False, True)
    with pytest.raises(ValueError, match="truncated"):
        xls._parse_sst(chunks[:1])
