"""Text parsing: libsvm -> RowBlock, and chunked reading of local files.

libsvm "label idx:val ..." (dmlc-core LibSVMParser). The criteo, adfea
and crb formats of the JAX package are not ported yet.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from wormhole_tpu_torch.data.rowblock import RowBlock


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


def parse_text(text: str, fmt: str) -> RowBlock:
    """Parse a chunk of text in the given format (libsvm only so far)."""
    if fmt != "libsvm":
        raise ValueError(f"unsupported data format: {fmt!r} (the port "
                         f"reads libsvm)")
    return parse_libsvm(text)


def iter_file_chunks(
    path: str,
    part: int = 0,
    num_parts: int = 1,
    chunk_bytes: int = 1 << 24,
) -> Iterator[str]:
    """Yield text chunks of (part k of n) of a local file, split on line
    boundaries — the InputSplit contract: a part starts at the first line
    beginning at-or-after its byte range start and ends at the first line
    boundary at-or-after its range end."""
    size = os.path.getsize(path)
    begin = size * part // num_parts
    end = size * (part + 1) // num_parts
    with open(path, "rb") as f:
        if begin > 0:
            f.seek(begin - 1)
            # consume the partial line belonging to the previous part
            f.readline()
        pos = f.tell()
        buf: list[bytes] = []
        buffered = 0
        while pos < end:
            line = f.readline()
            if not line:
                break
            pos = f.tell()
            buf.append(line)
            buffered += len(line)
            if buffered >= chunk_bytes:
                yield b"".join(buf).decode("utf-8", errors="replace")
                buf, buffered = [], 0
        if buf:
            yield b"".join(buf).decode("utf-8", errors="replace")
