#!/usr/bin/env python3
"""Variant lab for the GBDT level histogram (csrc/hist.cu) on one CUDA card.

  python3 tools/hist_lab.py [--other CHECKOUT] [NAME=EDITS ...]

Builds wormhole_tpu_torch/csrc/hist.cu once per variant, each with its
own values of constants (EDITS such as kThreads=512, or "default") or
with one of the design edits in PATCHES ("patch:NAME"; they match this
checkout's source and raise where it has changed), and with --other the
same source of another checkout (e.g. the parent commit unpacked with
git archive; its C entry may be the f32 one, which takes a scratch and an
output) as variant "other", all at once, each also to a cubin whose
atomics' SASS is printed beside ptxas's figures. Then, on the six levels
of a real boosting round at the bench's shape (chip_smoke.round_levels:
2,000,000 HIGGS rows of 28 features, 256 bins, depth 6), it holds each
variant against the plain version's f64 sums (atol 1e-4 + rtol 1e-5 of
the terms' magnitudes), says whether two launches give equal bits, and
times each level in turns (the variants in order, then in reverse): CUDA
events over 20 calls and the profiler's device time of a call. Prints
one JSON line per turn and one summary (medians over the turns of the
mean over the levels), with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_VARIANTS = ("default=default", "branchy=patch:branchy",
                    "hifirst=patch:hifirst", "native64=patch:native64",
                    "t512=kThreads=512", "nomerge=patch:nomerge",
                    "noadds=patch:noadds")
# Design edits: "native64" adds each fixed-point value to the tile with
# one 64-bit shared-memory atomicAdd (the first two planes of G and of H
# taken as one array of int64 cells) in place of the two 32-bit adds
# with a carry; "branchy" skips a 32-bit add where its word is zero (the
# first design); "hifirst" adds the high word first, with no wait on the
# low add, and the carry as a third add where there is one.
# Diagnostic edits, whose sums are wrong: "nomerge" makes no global add
# at the merge, "noadds" no shared add.
TURNS = 2
_ADD_FIXED = """  const uint32_t l = static_cast<uint32_t>(v);
  const uint32_t old = atomicAdd(&lo[cell], l);
  atomicAdd(reinterpret_cast<int*>(&lo[plane + cell]),
            static_cast<int>(v >> 32) + (old + l < old));"""
PATCHES = {
    "branchy": [(_ADD_FIXED, """  const uint32_t l = static_cast<uint32_t>(v);
  int hi = static_cast<int>(v >> 32);
  if (l != 0) {
    const uint32_t old = atomicAdd(&lo[cell], l);
    hi += old + l < old;
  }
  if (hi != 0) atomicAdd(reinterpret_cast<int*>(&lo[plane + cell]), hi);""")],
    "hifirst": [(_ADD_FIXED, """  const uint32_t l = static_cast<uint32_t>(v);
  atomicAdd(reinterpret_cast<int*>(&lo[plane + cell]),
            static_cast<int>(v >> 32));
  const uint32_t old = atomicAdd(&lo[cell], l);
  if (old + l < old) atomicAdd(reinterpret_cast<int*>(&lo[plane + cell]), 1);""")],
    "nomerge": [("""    if (s != 0)
      atomicAdd(dst""", """    if (s == 12345)
      atomicAdd(dst""")],
    "noadds": [(_ADD_FIXED, """  if (v == 12345) lo[cell] = 1;""")],
    "native64": [
        (_ADD_FIXED,
         """  if (v != 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(lo) + cell,
              static_cast<unsigned long long>(v));"""),
        ("""  const uint32_t l = lo[cell], hi = lo[plane + cell];
  lo[cell] = 0;
  lo[plane + cell] = 0;
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) | l);""",
         """  unsigned long long* c = reinterpret_cast<unsigned long long*>(lo) + cell;
  const long long v = static_cast<long long>(*c);
  *c = 0;
  return v;""")],
}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def variant_source(src: str, edits: str) -> str:
    """The source with a variant's edits, joined by '+': constants
    (NAME=VALUE) and design patches (patch:NAME)."""
    text = open(src).read()
    if edits == "default":
        return text
    for edit in edits.split("+"):
        if edit.startswith("patch:"):
            pairs = PATCHES[edit[6:]]
        else:
            k, v = edit.split("=")
            pairs = [(re.compile(rf"constexpr int {k} = \d+;"),
                      f"constexpr int {k} = {v};")]
        for old, new in pairs:
            if isinstance(old, str):
                old = re.compile(re.escape(old))
            text, n = old.subn(lambda _: new, text)
            if n != 1:
                raise ValueError(f"edit {edit}: the source has changed")
    return text


def build(name: str, src: str, out_dir) -> tuple:
    """Start nvcc of src into out_dir/lib<name>.so and into a cubin with
    ptxas's report."""
    from wormhole_tpu_torch.ops import _cuda

    so, cubin = out_dir / f"lib{name}.so", out_dir / f"{name}.cubin"
    flags = [f for f in _cuda.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    inc = ["-I", str(_cuda.CSRC)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in ([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *inc, "-o",
                          str(so), src],
                         [_cuda._nvcc(), *flags, *inc, "-cubin", "-Xptxas",
                          "-v", "-o", str(cubin), src])]
    return procs, so, cubin


def load(so) -> tuple:
    """The library and whether it has the fixed-point entry (a workspace
    sized by wh_level_hist_bytes) or the f32 one (scratch and output)."""
    lib = ctypes.CDLL(str(so))
    fixed = hasattr(lib, "wh_level_hist_bytes")
    if fixed:
        lib.wh_level_hist_bytes.argtypes = [_I64, _I, _I, _I, _P]
        lib.wh_level_hist.argtypes = [_P] * 5 + [_I64, _I, _I, _I, _P]
    else:
        lib.wh_level_scratch_ints.argtypes = [_I64, _I, _P]
        lib.wh_level_hist.argtypes = [_P] * 6 + [_I64, _I, _I, _I, _P]
    for fn in ("wh_level_hist", "wh_level_hist_bytes",
               "wh_level_scratch_ints"):
        if hasattr(lib, fn):
            getattr(lib, fn).restype = ctypes.c_int
    return lib, fixed


def level_hist(lib, fixed: bool, binned, g, h, rel, nodes: int, B: int):
    """One call of a variant's level_hist: (2, nodes, F, B) f32."""
    import torch

    rows, F = binned.shape
    n = ctypes.c_int64(0)
    st = torch.cuda.current_stream(binned.device).cuda_stream
    if fixed:
        lib.wh_level_hist_bytes(rows, F, B, nodes, ctypes.addressof(n))
        ws = torch.empty(n.value, dtype=torch.uint8, device=binned.device)
        rc = lib.wh_level_hist(binned.data_ptr(), g.data_ptr(), h.data_ptr(),
                               rel.data_ptr(), ws.data_ptr(), rows, F, B,
                               nodes, st)
        out = ws[:8 * nodes * F * B].view(torch.float32).view(2, nodes, F, B)
    else:
        lib.wh_level_scratch_ints(rows, nodes, ctypes.addressof(n))
        scratch = torch.empty(n.value, dtype=torch.int32,
                              device=binned.device)
        out = torch.empty(2, nodes, F, B, device=binned.device)
        rc = lib.wh_level_hist(binned.data_ptr(), g.data_ptr(), h.data_ptr(),
                               rel.data_ptr(), scratch.data_ptr(),
                               out.data_ptr(), rows, F, B, nodes, st)
    if rc:
        raise RuntimeError(f"level_hist: CUDA error {rc}")
    return out


def run_variant(lib, fixed: bool, ds, calls, refs, device,
                check: bool) -> dict:
    """The variant over the round's levels: per level ms (events), device
    ms (profiler), and on the first turn its largest error against the
    f64 sums over the bar and whether two launches gave equal bits."""
    import torch

    import chip_smoke as cs

    B = cs.GBDT_BINS
    out = {"ms": [], "device_ms": []}
    if check:
        out.update(worst_share_of_bar=0.0, equal_bits=True)
    for d, ((g, h, rel, nodes), (Gp, Hp, Gmag)) in enumerate(zip(calls,
                                                                  refs)):
        def call():
            return level_hist(lib, fixed, ds.binned, g, h, rel, nodes, B)
        if check:
            a, b = call(), call()
            torch.cuda.synchronize(device)
            out["equal_bits"] &= bool(torch.equal(a, b))
            for got, want, mag in ((a[0], Gp, Gmag), (a[1], Hp, Hp)):
                share = float(((got - want).abs() / (1e-4 + 1e-5 * mag))
                              .max())
                out["worst_share_of_bar"] = max(out["worst_share_of_bar"],
                                                share)
        out["ms"].append(cs.time_ms(call, device))
        out["device_ms"].append(cs.device_ms(call, device))
        if check and d in (0, len(calls) - 1):
            out[f"split_level_{d}"] = cs.device_split(call, device)
    out["ms_mean"] = statistics.mean(out["ms"])
    out["device_ms_mean"] = statistics.mean(out["device_ms"])
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("hist_lab: CUDA is not available", file=sys.stderr)
        return 2
    from wormhole_tpu_torch.ops import _cuda
    from wormhole_tpu_torch.ops import hist as hk

    import chip_smoke as cs

    other = None
    if argv[:1] == ["--other"]:
        other, argv = argv[1], argv[2:]
    specs = argv or list(DEFAULT_VARIANTS)
    out_dir = _cuda.BUILD_DIR / "hist_lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(_cuda.CSRC / "hist.cu")
    builds = {}
    for spec in specs:
        name, edits = spec.split("=", 1)
        vsrc = out_dir / f"{name}.cu"
        vsrc.write_text(variant_source(src, edits))
        builds[name] = build(name, str(vsrc), out_dir)
    if other:
        builds["other"] = build("other", os.path.join(
            other, "wormhole_tpu_torch/csrc/hist.cu"), out_dir)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = {}
    for name, (procs, so, cubin) in builds.items():
        texts = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc of variant {name} failed:\n"
                               + "\n".join(texts))
        regs = re.findall(r"level_hist_kernel\w*' for[\s\S]{0,300}?"
                          r"(\d+ bytes spill stores)[\s\S]{0,200}?Used "
                          r"(\d+) registers", texts[1])
        sass = (cs.sass_atomics(tool, cubin, "level_hist_kernel")
                if os.path.exists(tool) else "no cuobjdump")
        print(f"[hist-lab] {name}: level_hist_kernel registers {regs}, "
              f"atomics in SASS {sass}", flush=True)
        libs[name] = load(so)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    ds, calls = cs.round_levels(device, cs.make_higgs())
    refs = []
    for g, h, rel, nodes in calls:
        Gp, Hp = hk.level_hist_plain(ds.binned, g, h, rel, nodes,
                                     cs.GBDT_BINS, acc_dtype=torch.float64)
        Gmag, _ = hk.level_hist_plain(ds.binned, g.abs(), h, rel, nodes,
                                      cs.GBDT_BINS, acc_dtype=torch.float64)
        refs.append((Gp, Hp, Gmag))
    print(f"[hist-lab] {smi}; levels of {[c[3] for c in calls]} nodes",
          flush=True)
    order = list(libs)
    times = {n: [] for n in order}
    for turn in range(TURNS):
        for name in (order if turn % 2 == 0 else order[::-1]):
            got = run_variant(*libs[name], ds, calls, refs, device,
                              turn == 0)
            times[name].append(got)
            print(json.dumps({"turn": turn, "variant": name, **got}),
                  flush=True)
    summary = {n: {k: statistics.median(t[k] for t in ts)
                   for k in ("ms_mean", "device_ms_mean")}
               | {k: ts[0][k] for k in ("worst_share_of_bar", "equal_bits")}
               for n, ts in times.items()}
    print(f"[hist-lab] {smi}: " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
