"""Text parsing: libsvm -> RowBlock, and chunked reading of local files.

libsvm "label idx:val ..." (dmlc-core LibSVMParser). parse_libsvm is
the plain parser, the contract of the card's (native.py, csrc/parse.cu).
The criteo, adfea and crb formats of the JAX package are not ported yet.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from wormhole_tpu_torch import native
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


def parse_text(text, fmt: str, device=None) -> RowBlock:
    """Parse a chunk (str or bytes) in the given format (libsvm only so
    far) on `device`: parse_libsvm on the CPU (None or "cpu"), the card's
    parser (csrc/parse.cu, native.parse_libsvm_cuda) on CUDA. The
    learners pass their own device."""
    if fmt != "libsvm":
        raise ValueError(f"unsupported data format: {fmt!r} (the port "
                         f"reads libsvm)")
    dev = native.as_device(device)
    if dev.type == "cpu":
        if not isinstance(text, str):
            text = bytes(text).decode("utf-8", errors="replace")
        return parse_libsvm(text)
    return native.parse_libsvm_cuda(text, dev)


def iter_file_chunks(
    path: str,
    part: int = 0,
    num_parts: int = 1,
    chunk_bytes: int = 1 << 24,
) -> Iterator[str]:
    """Yield text chunks of (part k of n) of a local file, split on line
    boundaries — the InputSplit contract: a part starts at the first line
    beginning at-or-after its byte range start and ends at the first line
    boundary at-or-after its range end. A chunk ends at the first line
    boundary at-or-after chunk_bytes from its start (or the part's end),
    as the JAX package's line-by-line reader cuts it; the file is read a
    block at a time (a few calls a chunk, not two a line: loader threads
    that read line by line queue on the interpreter lock)."""
    size = os.path.getsize(path)
    begin = size * part // num_parts
    end = size * (part + 1) // num_parts
    with open(path, "rb") as f:
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
