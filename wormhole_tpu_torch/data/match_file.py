"""Regex file matching over a directory, URI-style.

The port's copy of the JAX package's data/match_file.py. Parity with
reference learn/base/match_file.h:12-45: the pattern's directory part is
listed and the basename is applied as a POSIX regex against entries.
Works uniformly over URI schemes through data/filesys (local fully; gs://
and s3:// when their client is present; any scheme via
register_filesystem) — the reference routes through dmlc-core
FileSystem::ListDirectory the same way. Imports neither torch nor numpy.
"""

from __future__ import annotations

import re

from wormhole_tpu_torch.data import filesys as fsys


def match_file(pattern: str) -> list[str]:
    """Return sorted files whose basename matches the regex ``pattern``'s
    basename, within its directory. A plain existing file matches itself."""
    if fsys.isfile(pattern):
        return [pattern]
    dirname = fsys.dirname(pattern) or "."
    base = fsys.basename(pattern)
    try:
        rx = re.compile(base)
    except re.error as e:
        raise ValueError(f"bad file regex {base!r}: {e}") from None
    if not fsys.isdir(dirname):
        return []
    out = [
        fsys.join(dirname, name)
        for name in fsys.list_dir(dirname)
        if rx.search(name) and fsys.isfile(fsys.join(dirname, name))
    ]
    return sorted(out)
