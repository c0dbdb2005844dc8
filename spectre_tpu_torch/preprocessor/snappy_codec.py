"""Pure-Python snappy *raw block* codec (the port's copy of
`spectre_tpu/preprocessor/snappy_codec.py`).

The official consensus-spec-tests fixtures are `.ssz_snappy` files: SSZ bytes
under snappy raw-block compression (no framing). The reference reads them via
the `snap` crate (`test-utils` `load_snappy_ssz`); the port takes no snappy
binding, so decompression is implemented here from the format spec
(varint preamble + literal/copy tagged elements).

`compress` emits a valid literal-only stream (legal snappy: the format does
not require copy elements), which is all the self-generated fixture needs —
real downloaded fixtures exercise the full decompressor.
"""

from __future__ import annotations


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift >= 64:
            raise ValueError("uvarint too long")


def _write_uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    """Raw snappy block decompression (literals + copy1/copy2/copy4)."""
    expected, pos = _read_uvarint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                      # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                if pos + nbytes > n:
                    raise ValueError("truncated snappy stream (literal length)")
                ln = int.from_bytes(data[pos:pos + nbytes], "little")
                pos += nbytes
            ln += 1
            if pos + ln > n:
                raise ValueError("truncated snappy stream (literal body)")
            out += data[pos:pos + ln]
            pos += ln
        else:
            if kind == 1:                  # copy, 1-byte offset
                if pos + 1 > n:
                    raise ValueError("truncated snappy stream (copy1 offset)")
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:                # copy, 2-byte offset
                if pos + 2 > n:
                    raise ValueError("truncated snappy stream (copy2 offset)")
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:                          # copy, 4-byte offset
                if pos + 4 > n:
                    raise ValueError("truncated snappy stream (copy4 offset)")
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            if not 0 < off <= len(out):
                raise ValueError("snappy copy offset out of range")
            start = len(out) - off
            if off >= ln:                  # non-overlapping: slice copy
                out += out[start:start + ln]
            else:
                # overlapping copies are legal (byte-at-a-time semantics)
                for i in range(ln):
                    out.append(out[start + i])
    if len(out) != expected:
        raise ValueError(f"snappy length mismatch: {len(out)} != {expected}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Literal-only snappy stream (valid for any decompressor)."""
    out = bytearray(_write_uvarint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out += ln.to_bytes(1, "little")
        else:                       # chunks are capped at 65536: ln < 2^16
            out.append(61 << 2)
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
