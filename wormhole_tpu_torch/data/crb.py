"""CRB: compressed row block binary format (reader + writer).

Structural parity with reference learn/base/compressed_row_block.h +
crb_parser.h: each record is one RowBlock with every field (label / offset /
index / value / weight) compressed independently, framed by a magic number
and an index-type tag, stored in a recordio-style stream that can be split
by record for sharded reading. Codec is zlib (in the Python stdlib) rather
than LZ4 — the on-disk format is ours, only the design is parity.

The port's copy of the JAX package's module: the same bytes on disk, so
either package reads the other's files. Host code on every device (zlib
has no kernel); any URI data/filesys.py binds, as data/parsers.py
iter_file_chunks reads them.

Record layout (little-endian):
  u32 magic (0x57524254 'WRBT') | u32 flags | u32 num_rows |
  5 x { u64 compressed_len | bytes }   fields in order:
      label f32[n], offset i64[n+1], index u64[nnz], value f32[nnz] (may be
      empty -> binary), weight f32[n] (may be empty)
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from wormhole_tpu_torch.data import filesys as fsys
from wormhole_tpu_torch.data.rowblock import RowBlock

MAGIC = 0x57524254


def _pack_field(arr: Optional[np.ndarray]) -> bytes:
    raw = b"" if arr is None else np.ascontiguousarray(arr).tobytes()
    comp = zlib.compress(raw, 1)
    return struct.pack("<Q", len(comp)) + comp


def write_crb(path: str, blocks, append: bool = False) -> int:
    """Write RowBlocks as CRB records; returns #records written."""
    n = 0
    with fsys.open_stream(path, "ab" if append else "wb") as f:
        for blk in blocks:
            rec = [struct.pack("<III", MAGIC, 0, blk.size)]
            rec.append(_pack_field(np.asarray(blk.label, np.float32)))
            rec.append(_pack_field(np.asarray(blk.offset, np.int64)))
            rec.append(_pack_field(np.asarray(blk.index, np.uint64)))
            rec.append(_pack_field(blk.value))
            rec.append(_pack_field(blk.weight))
            f.write(b"".join(rec))
            n += 1
    return n


def _read_field(f, dtype) -> Optional[np.ndarray]:
    (clen,) = struct.unpack("<Q", f.read(8))
    raw = zlib.decompress(f.read(clen))
    if not raw:
        return None
    return np.frombuffer(raw, dtype=dtype).copy()


def _read_record(f) -> Optional[RowBlock]:
    hdr = f.read(12)
    if len(hdr) < 12:
        return None
    magic, _flags, _n = struct.unpack("<III", hdr)
    if magic != MAGIC:
        raise ValueError(f"bad CRB magic {magic:#x}")
    label = _read_field(f, np.float32)
    offset = _read_field(f, np.int64)
    index = _read_field(f, np.uint64)
    value = _read_field(f, np.float32)
    weight = _read_field(f, np.float32)
    if index is None:
        index = np.zeros(0, dtype=np.uint64)
    return RowBlock(label=label, offset=offset, index=index, value=value,
                    weight=weight)


def _skip_record(f) -> bool:
    """Seek past one record without decompressing; False at EOF."""
    hdr = f.read(12)
    if len(hdr) < 12:
        return False
    magic, _flags, _n = struct.unpack("<III", hdr)
    if magic != MAGIC:
        raise ValueError(f"bad CRB magic {magic:#x}")
    for _ in range(5):
        (clen,) = struct.unpack("<Q", f.read(8))
        f.seek(clen, 1)
    return True


def read_crb(path: str, part: int = 0, num_parts: int = 1) -> Iterator[RowBlock]:
    """Stream records of (part k of n): records are dealt round-robin to
    parts (disjoint-cover contract of InputSplit); other parts' records are
    seeked over via the length prefixes, not decompressed."""
    with fsys.open_stream(path, "rb") as f:
        i = 0
        while True:
            if i % num_parts == part:
                blk = _read_record(f)
                if blk is None:
                    return
                yield blk
            elif not _skip_record(f):
                return
            i += 1
