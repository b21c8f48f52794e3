"""Binary LIF container parsing and writing.

The counterpart of lif_tpu.io.container (copied, not imported: the port
imports nothing of lif_tpu). Format (reference: src/LifLoader.ts:380-406):
a LIF file is a JPEG with a trailing metadata region —

    <jpeg bytes ...>
    <region: field_count:u32be, then field_count x
             (field_type:u32be, field_size:u32be, field_bytes)>
    <region_offset:u32be>   # distance from region start to EOF
    <magic:u16be = 0x1E1A>  # at EOF-2

JSON scene metadata lives in the field with type 8 (new) or 7 (legacy)
(reference: LifLoader.ts:277-287). Image/depth/mask payloads are fields
addressed by ``blob_id`` == field type; ``blob_id == -1`` means "the whole
file" (the outer JPEG). (reference: LifLoader.ts:450-461)
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

__all__ = ["Container", "Field", "LifParseError", "parse", "parse_file",
           "write"]

MAGIC = 0x1E1A
JSON_META = 7
JSON_META_NEW = 8


class LifParseError(ValueError):
    pass


@dataclass
class Field:
    """One metadata field: a typed blob."""

    field_type: int
    data: bytes

    def json(self):
        return json.loads(self.data.decode("utf-8"))


@dataclass
class Container:
    """Parsed LIF container: the raw file plus its metadata fields."""

    raw: bytes
    fields: list[Field] = field(default_factory=list)

    def field_by_type(self, field_type: int) -> Field | None:
        for f in self.fields:
            if f.field_type == field_type:
                return f
        return None

    def json_meta(self):
        """Scene JSON from field 8, else 7. reference: LifLoader.ts:277-287."""
        f = self.field_by_type(JSON_META_NEW) or self.field_by_type(JSON_META)
        if f is None:
            raise LifParseError("Failed to extract LIF meta")
        return f.json()

    def blob(self, blob_id: int) -> bytes:
        """Payload bytes for a blob reference; -1 = the whole file.
        reference: LifLoader.ts:450-461."""
        if blob_id == -1:
            return self.raw
        f = self.field_by_type(blob_id)
        if f is None:
            raise LifParseError(f"No field with type {blob_id}")
        return f.data


def parse(data: bytes, prefer_native: bool = True) -> Container:
    """Parse a LIF byte string.

    reference semantics: magic u16 at EOF-2 must be 0x1E1A; u32 at EOF-6 is
    the offset (from EOF) of the region start; the region holds a u32 field
    count then (type, size, bytes) records. (LifLoader.ts:380-406)

    With prefer_native, the field table is scanned by the C++ codec
    (lif_tpu_torch.io.native) when it builds, else in pure Python; both
    raise LifParseError on a malformed file.
    """
    if prefer_native:
        try:
            from . import native as _native

            fields_nat = _native.parse_fields(data)
        except ValueError as e:
            raise LifParseError(str(e)) from e
        except Exception:
            fields_nat = None
        if fields_nat is not None:
            return Container(
                raw=bytes(data),
                fields=[
                    Field(ftype, bytes(data[off : off + size]))
                    for ftype, off, size in fields_nat
                ],
            )
    n = len(data)
    if n < 8:
        raise LifParseError("Not a LIF file (too short)")
    (magic,) = struct.unpack_from(">H", data, n - 2)
    if magic != MAGIC:
        raise LifParseError("Not a LIF file (bad magic)")
    (region_offset,) = struct.unpack_from(">I", data, n - 6)
    pos = n - region_offset
    if pos < 0 or pos > n - 6:
        raise LifParseError("Corrupt LIF region offset")

    (count,) = struct.unpack_from(">I", data, pos)
    pos += 4
    fields = []
    for _ in range(count):
        if pos + 8 > n:
            raise LifParseError("Truncated LIF field table")
        ftype, fsize = struct.unpack_from(">II", data, pos)
        pos += 8
        if pos + fsize > n:
            raise LifParseError("Truncated LIF field payload")
        fields.append(Field(ftype, bytes(data[pos : pos + fsize])))
        pos += fsize
    return Container(raw=bytes(data), fields=fields)


def parse_file(path) -> Container:
    with open(path, "rb") as f:
        return parse(f.read())


def write(jpeg_bytes: bytes, json_meta, blobs: dict[int, bytes] | None = None) -> bytes:
    """Author a LIF file: outer JPEG + JSON meta (field 8) + payload blobs.

    ``blobs`` maps blob_id (field type) -> bytes. The writer produces the
    same layout the parser (and the reference loader) reads.
    """
    blobs = blobs or {}
    fields: list[tuple[int, bytes]] = [
        (JSON_META_NEW, json.dumps(json_meta).encode("utf-8"))
    ]
    for blob_id, payload in sorted(blobs.items()):
        if blob_id in (JSON_META, JSON_META_NEW):
            raise ValueError(f"blob_id {blob_id} is reserved for JSON metadata")
        fields.append((blob_id, payload))

    region = struct.pack(">I", len(fields))
    for ftype, payload in fields:
        region += struct.pack(">II", ftype, len(payload)) + payload

    # region_offset counts from region start to EOF, which includes the
    # region itself plus the 6-byte trailer.
    region_offset = len(region) + 6
    return jpeg_bytes + region + struct.pack(">I", region_offset) + struct.pack(">H", MAGIC)
