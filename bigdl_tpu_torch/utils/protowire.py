"""Protobuf wire-format framing, ported from
``bigdl_tpu/utils/protowire.py``: the varints and length-delimited
fields that the BTPU checkpoint format (``utils/module_format.py``) is
written in.  The packed-number decoders of the JAX module (used by its
TFRecord and Caffe readers, not ported yet) wait with them."""

from __future__ import annotations

from typing import Iterator, Tuple, Union

__all__ = ["read_varint", "fields", "write_varint", "emit_varint",
           "emit_bytes"]


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """(field_number, wire_type, value) over a message buffer:
    length-delimited and fixed-width values as bytes, varints as
    unsigned ints."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def write_varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b7 = n & 0x7F
        n >>= 7
        out.append(b7 | (0x80 if n else 0))
        if not n:
            return bytes(out)


def emit_varint(field: int, value: int) -> bytes:
    return write_varint((field << 3) | 0) + write_varint(value)


def emit_bytes(field: int, payload: bytes) -> bytes:
    return write_varint((field << 3) | 2) + write_varint(len(payload)) \
        + payload
