"""convert: offline data-format converter (reference learn/tool/convert.cc
+ text2crb.cc): libsvm / criteo / criteo_test / adfea / crb input ->
libsvm or crb output, with size-based output sharding `-part_XX`
(convert.cc:62-106).

  python -m wormhole_tpu_torch.apps.convert data_in=day_0 format_in=criteo \
      data_out=day_0.crb format_out=crb part_size=512 [device=cuda]

Text input is parsed on the card (`device=cuda`, the default) unless the
user names the CPU (`device=cpu`); the output is written on the host. The
files are those of the JAX package's convert, byte for byte. As there, a
crb output is always appended to (convert.cc's writer never truncates):
converting twice into an existing path doubles its records.
"""

from __future__ import annotations

import dataclasses
import os
import sys

from wormhole_tpu_torch.apps._runner import parse_cli
from wormhole_tpu_torch.data.crb import write_crb
from wormhole_tpu_torch.data.minibatch import MinibatchIter
from wormhole_tpu_torch.solver.workload import match_file


@dataclasses.dataclass
class ConvertConfig:
    """gflags surface of convert.cc:16-21 (names kept)."""

    data_in: str = ""
    format_in: str = "libsvm"    # libsvm | criteo | criteo_test | adfea | crb
    data_out: str = ""
    format_out: str = "crb"      # crb | libsvm
    part_size: int = 0           # MB per output shard; 0 = single file
    minibatch: int = 65536


def _write_libsvm(f, blk) -> None:
    vals = blk.values_or_ones()
    for r in range(blk.size):
        lo, hi = int(blk.offset[r]), int(blk.offset[r + 1])
        feats = " ".join(
            f"{int(blk.index[j])}:{vals[j]:.6g}" for j in range(lo, hi))
        f.write(f"{blk.label[r]:.6g} {feats}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_cli(ConvertConfig, argv)
    if not (cfg.data_in and cfg.data_out):
        raise ValueError("need data_in= and data_out=")
    if cfg.format_out not in ("crb", "libsvm"):
        raise ValueError(f"format_out must be crb or libsvm, got "
                         f"{cfg.format_out!r}")
    files = match_file(cfg.data_in)
    if not files:
        raise FileNotFoundError(cfg.data_in)

    part, written = 0, 0
    limit = cfg.part_size * (1 << 20)
    out_path = None
    out_f = None

    def roll():
        nonlocal part, written, out_path, out_f
        if out_f:
            out_f.close()
            out_f = None
        out_path = (f"{cfg.data_out}-part_{part:02d}" if limit
                    else cfg.data_out)
        part += 1
        written = 0
        if cfg.format_out == "libsvm":
            out_f = open(out_path, "w")

    roll()
    nrec = 0
    for path in files:
        for blk in MinibatchIter(path, 0, 1, cfg.format_in,
                                 minibatch_size=cfg.minibatch,
                                 device=device):
            if cfg.format_out == "crb":
                write_crb(out_path, [blk], append=True)
                written = os.path.getsize(out_path)
            else:
                _write_libsvm(out_f, blk)
                written = out_f.tell()
            nrec += blk.size
            if limit and written >= limit:
                roll()
    if out_f:
        out_f.close()
    print(f"converted {nrec} rows from {len(files)} file(s) into "
          f"{part if limit else 1} output part(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
