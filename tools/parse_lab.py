#!/usr/bin/env python3
"""The card's parses on one CUDA card, split by the device ops of a call.

  python3 tools/parse_lab.py [--other CHECKOUT] [--turns N] [--patch NAME]
                             [--chunks libsvm|formats|all]

Runs each checkout's parse kernels (this one's, and with --other
another's, e.g. the parent commit unpacked with git archive) over
chip_smoke.py's [parse] chunks, each checkout in a process of its own, in
turns (other, this, this, other for two turns): with --chunks libsvm (the
default) parse_libsvm_kernel over the four libsvm chunks (65,536 rows
each: Criteo keys, the same keys with k:v values, HIGGS rows, HIGGS rows
written %.17g); with --chunks formats parse_criteo_kernel and
parse_adfea_kernel over format_chunks' criteo, criteo_test,
criteo-sweep and adfea chunks; all, both. For each chunk: the RowBlock
against the plain parser's byte
for byte, the chain's times as chip_smoke.py takes them (ms by CUDA
events, device ms by the profiler, host us to enqueue), the whole call
(bytes over, parse, arrays back; best of three), the byte bound, and the
device ops a call by name in launch order with their device ms (the
profiler's events). Prints one JSON line per checkout and chunk and
turn, and the card's name and power limit. --patch NAME (repeatable)
adds a turn of this checkout with one of the edits of PATCHES built in:
a variant's RowBlocks are checked, a diagnostic's are not.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Edits of a source, by name: (source, edits, checked). A diagnostic's
# output is wrong and is not checked: "noconvert" (csrc/parse.cu) queues
# the tokens but converts none of them; "noconvert-formats"
# (csrc/formats.cu) the same for the criteo and adfea cells and tokens.
# A variant's RowBlocks are held against the plain parser's: "fid19"
# folds an adfea int() into its 128-bit accumulator 19 digits at a time;
# "emit3" asks for three emit CTAs an SM (42 registers a thread).
PATCHES = {
    "noconvert": ("parse", [("""  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Conv conv = kConvFast;""", """  if (k > 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Conv conv = kConvFast;""")], False),
    "noconvert-formats": ("formats", [("""  const int lane = threadIdx.x & 31;
  Conv conv = kConvFast;""", """  if (k > 0) return;
  const int lane = threadIdx.x & 31;
  Conv conv = kConvFast;""")], False),
    "fid19": ("formats", [("""  uint64_t l = 0, h = 0;
  for (; i < len; ++i) {
    if (p[i] == '_') continue;
    h = h * 10 + __umul64hi(l, 10);
    l *= 10;
    const uint64_t s = l + (p[i] - '0');
    h += s < l;
    l = s;
  }""", """  uint64_t l = 0, h = 0, c = 0, m = 1;
  for (; i < len; ++i) {
    if (p[i] == '_') continue;
    c = c * 10 + (p[i] - '0');
    m *= 10;
    if (m == 10000000000000000000ull || i + 1 == len) {
      const uint64_t lo = l * m;
      h = h * m + __umul64hi(l, m);
      l = lo + c;
      h += l < lo;
      c = 0;
      m = 1;
    }
  }""")], True),
    "emit3": ("formats", [("""__global__ void __launch_bounds__(kTileThreads)
formats_emit_kernel(""", """__global__ void __launch_bounds__(kTileThreads, 3)
formats_emit_kernel(""")], True),
}


def load_patched(patch: str) -> None:
    """Build a source with a diagnostic edit and put it in place of its
    library."""
    import ctypes

    from wormhole_tpu_torch.ops import _cuda

    name, edits, _ = PATCHES[patch]
    src = open(_cuda.CSRC / f"{name}.cu").read()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"patch {patch}: the source has changed")
        src = src.replace(old, new)
    d = _cuda.BUILD_DIR / "parse_lab"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{patch}.cu").write_text(src)
    so = d / f"lib{name}_{patch}.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(so), str(d / f"{patch}.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _cuda._SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, _cuda._ERROR_STRING[name])
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _cuda._libs[name] = lib


def lab_chunks(cs, which: str) -> list:
    """(name, format, bytes) of the chunks `which` names."""
    rows = cs.PARSE_ROWS
    out = []
    if which in ("libsvm", "all"):
        out += [(name, "libsvm", text.encode()) for name, text in (
            ("criteo-keys", cs.criteo_text(cs.COMPACT_BUCKETS, rows, 31)),
            ("criteo-values", cs.criteo_text(cs.COMPACT_BUCKETS, rows, 31,
                                             values=True)),
            ("higgs", cs.higgs_text(rows, cs.HIGGS_DIM, 32)),
            ("higgs-17g", cs.higgs_text(rows, cs.HIGGS_DIM, 32, "%.17g")))]
    if which in ("formats", "all"):
        out += list(cs.format_chunks(rows))
    return out


def worker(checkout: str, which: str = "libsvm",
           patch: str | None = None) -> int:
    """One checkout's numbers, in this process (its package first on the
    path; the chunks and timers from this checkout's chip_smoke.py), with
    a diagnostic patch where named."""
    sys.path.insert(0, checkout)
    sys.path.insert(1, ROOT)
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lab", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from wormhole_tpu_torch import native
    from wormhole_tpu_torch.data.parsers import parse_text

    assert native.__file__.startswith(os.path.abspath(checkout)), \
        native.__file__
    if patch:
        load_patched(patch)
    device = torch.device("cuda", 0)
    kernels = {"libsvm": native.parse_libsvm_kernel,
               "criteo": native.parse_criteo_kernel,
               "criteo_test": lambda b: native.parse_criteo_kernel(b, False),
               "adfea": native.parse_adfea_kernel}
    for name, fmt, raw in lab_chunks(cs, which):
        want = parse_text(raw, fmt)
        got, walls = cs._card_walls(
            lambda: parse_text(raw, fmt, device), device)
        if not patch or PATCHES[patch][2]:
            cs.same_arrays(name, cs.rowblock_arrays(got),
                           cs.rowblock_arrays(want))
        buf = native.upload(raw, device)

        def call():
            return kernels[fmt](buf)

        tm = cs.timings(call, device)
        nnz = want.nnz
        nbytes = (len(raw) + 4 * want.size + 8 * (want.size + 1) + 8 * nnz
                  + (4 * nnz if want.value is not None else 0))
        split = cs.device_split(call, device)
        print(json.dumps({"checkout": checkout, "patch": patch,
                          "chunk": name, "format": fmt,
                          "mb": len(raw) / 1e6, **tm,
                          "call_ms": 1e3 * min(walls),
                          "bound_ms": cs.bound_ms(nbytes, 0.0)[0],
                          "device_ops_per_call": sum(k[1] for k in split),
                          "split": split}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker(*argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("parse_lab: CUDA is not available", file=sys.stderr)
        return 2
    other, turns, patches, which = None, 2, [], "libsvm"
    while argv:
        if argv[0] == "--other":
            other, argv = os.path.abspath(argv[1]), argv[2:]
        elif argv[0] == "--turns":
            turns, argv = int(argv[1]), argv[2:]
        elif argv[0] == "--chunks":
            which, argv = argv[1], argv[2:]
            if which not in ("libsvm", "formats", "all"):
                raise SystemExit(f"parse_lab: --chunks {which}?")
        elif argv[0] == "--patch":
            patches, argv = patches + [argv[1]], argv[2:]
        else:
            raise SystemExit(f"parse_lab: unknown argument {argv[0]}")
    sys.path.insert(0, ROOT)
    from wormhole_tpu_torch.ops import _cuda

    _cuda.build(["parse", "formats"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[parse-lab] {smi}", flush=True)
    order = [other, ROOT] if other else [ROOT]
    runs = [[c, which] for turn in range(turns)
            for c in (order if turn % 2 == 0 else order[::-1])]
    for args in runs + [[ROOT, which, p] for p in patches]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--worker", *args], cwd=args[0]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
