"""Text parsing: libsvm, Criteo CTR, adfea -> RowBlock, and chunked
reading of local files.

- libsvm "label idx:val ..." (dmlc-core LibSVMParser);
- criteo: tab-separated, a label then 13 int + 26 categorical fields,
  each hashed with CityHash64 and field-packed (reference
  learn/base/criteo_parser.h:38-88); criteo_test has no label;
- adfea "lineid #feat label fid:gid ..." (learn/base/adfea_parser.h:35-90).

parse_libsvm, parse_criteo and parse_adfea are the plain parsers, copies
of the JAX package's Python parsers, and the contracts of the card's
(native.py; csrc/parse.cu for libsvm, csrc/formats.cu for criteo and
adfea). The crb binary format is data/crb.py.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from wormhole_tpu_torch import native
from wormhole_tpu_torch.data.rowblock import RowBlock
from wormhole_tpu_torch.ops.hashing import pack_field_key

_M = (1 << 64) - 1


def parse_libsvm(text: str) -> RowBlock:
    labels: list[float] = []
    offsets: list[int] = [0]
    idx: list[int] = []
    val: list[float] = []
    has_val = False
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        for tok in parts[1:]:
            if ":" in tok:
                k, v = tok.split(":", 1)
                idx.append(int(k))
                v = float(v)
                val.append(v)
                if v != 1.0:
                    has_val = True
            else:
                idx.append(int(tok))
                val.append(1.0)
        offsets.append(len(idx))
    return RowBlock(
        label=np.asarray(labels, dtype=np.float32),
        offset=np.asarray(offsets, dtype=np.int64),
        index=np.asarray(idx, dtype=np.uint64),
        # binary compaction: drop the all-ones value array
        # (reference minibatch_iter.h:114-116)
        value=np.asarray(val, dtype=np.float32) if has_val else None,
    )


def parse_criteo(text: str, has_label: bool = True) -> RowBlock:
    """Criteo CTR lines: label \\t I1..I13 \\t C1..C26 (train) or no label
    (test). The raw token text is hashed and the field id packed into the
    top 10 bits (criteo_parser.h:69-82). Missing fields are skipped but
    keep their field number; fields past the 39th are ignored. All
    features are binary (value 1)."""
    labels: list[float] = []
    offsets: list[int] = [0]
    idx: list[int] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        toks = line.rstrip("\n").split("\t")
        pos = 0
        if has_label:
            labels.append(float(toks[0]))
            pos = 1
        else:
            labels.append(0.0)
        for field, tok in enumerate(toks[pos:]):
            if field >= 39:
                break
            if tok == "":
                continue
            idx.append(pack_field_key(tok, field))
        offsets.append(len(idx))
    return RowBlock(
        label=np.asarray(labels, dtype=np.float32),
        offset=np.asarray(offsets, dtype=np.int64),
        index=np.asarray(idx, dtype=np.uint64),
        value=None,
    )


def parse_adfea(text: str) -> RowBlock:
    """adfea: "lineid num_features label fid:gid fid:gid ...". The group id
    is packed into the top 10 bits like criteo (adfea_parser.h:56-64);
    labels are 0/1 like the other parsers (adfea_parser.h emits 0/1)."""
    labels: list[float] = []
    offsets: list[int] = [0]
    idx: list[int] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 3:
            continue
        labels.append(1.0 if float(parts[2]) > 0 else 0.0)
        for tok in parts[3:]:
            if ":" in tok:
                fid, gid = tok.split(":", 1)
                key = ((int(fid) >> 10) | ((int(gid) & 0x3FF) << 54)) & _M
            else:
                key = int(tok)
            idx.append(key)
        offsets.append(len(idx))
    return RowBlock(
        label=np.asarray(labels, dtype=np.float32),
        offset=np.asarray(offsets, dtype=np.int64),
        index=np.asarray(idx, dtype=np.uint64),
        value=None,
    )


_PARSERS = {
    "libsvm": parse_libsvm,
    "criteo": lambda t: parse_criteo(t, has_label=True),
    "criteo_test": lambda t: parse_criteo(t, has_label=False),
    "adfea": parse_adfea,
}


def parse_text(text, fmt: str, device=None) -> RowBlock:
    """Parse a chunk (str or bytes) in format `fmt` (libsvm, criteo,
    criteo_test or adfea) on `device`: the plain parser on the CPU (None
    or "cpu"), the card's parser on CUDA (native.parse_libsvm_cuda,
    parse_criteo_cuda, parse_adfea_cuda). The learners pass their own
    device. ValueError for any other format."""
    if fmt not in _PARSERS:
        raise ValueError(f"unknown data format: {fmt!r} (the port reads "
                         f"{', '.join(_PARSERS)} and crb)")
    dev = native.as_device(device)
    if dev.type == "cpu":
        if not isinstance(text, str):
            text = bytes(text).decode("utf-8", errors="replace")
        return _PARSERS[fmt](text)
    if fmt == "libsvm":
        return native.parse_libsvm_cuda(text, dev)
    if fmt == "adfea":
        return native.parse_adfea_cuda(text, dev)
    return native.parse_criteo_cuda(text, dev, has_label=fmt == "criteo")


def iter_file_chunks(
    path: str,
    part: int = 0,
    num_parts: int = 1,
    chunk_bytes: int = 1 << 24,
) -> Iterator[str]:
    """Yield text chunks of (part k of n) of a file, split on line
    boundaries — the InputSplit contract: a part starts at the first line
    beginning at-or-after its byte range start and ends at the first line
    boundary at-or-after its range end. A chunk ends at the first line
    boundary at-or-after chunk_bytes from its start (or the part's end),
    as the JAX package's line-by-line reader cuts it; the file is read a
    block at a time (a few calls a chunk, not two a line: loader threads
    that read line by line queue on the interpreter lock). `path` may be
    any URI data/filesys.py binds (Stream::Create parity)."""
    from wormhole_tpu_torch.data import filesys as fsys

    size = fsys.getsize(path)
    begin = size * part // num_parts
    end = size * (part + 1) // num_parts
    with fsys.open_stream(path, "rb") as f:
        if begin > 0:
            f.seek(begin - 1)
            # consume the partial line belonging to the previous part
            f.readline()
        pos = f.tell()
        while pos < end:
            block = f.read(min(chunk_bytes, end - pos))
            if not block:
                break
            if not block.endswith(b"\n"):
                block += f.readline()  # finish the line the block cut
            pos += len(block)
            yield block.decode("utf-8", errors="replace")
