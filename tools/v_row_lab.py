#!/usr/bin/env python3
"""Variant lab for DiFacto's two V-row kernels on one CUDA card.

  python3 tools/v_row_lab.py [--other CHECKOUT] [NAME=EDITS ...]

Builds wormhole_tpu_torch/csrc/fused_update.cu once per variant, each
with its own values of the row kernels' launch-shape constants
(kRowCtasPerSm, kGatherBatch, kUpdateBatch; EDITS is a comma-separated
list such as kRowCtasPerSm=4,kUpdateBatch=4, or "default"), or with one
of the diagnostic edits in PATCHES (EDITS "patch:NAME"; the edits match
this checkout's source and raise where it has changed), and with --other
the same source of another checkout (e.g. the parent commit unpacked
with git archive) as variant "other". All builds run at once. Then on the DiFacto bench batch (chip_smoke.py's: 2^22 / 2^20
buckets, dim 8, the learner's own pack of the second batch of a pass) it
holds each variant's row_tile_gather and v_scatter_update against their
plain versions (not the patched ones, whose numbers are not the update's)
and times them in turns (the variants in order, then in reverse): the
profiler's device time of one call back to back ("warm": the touched
rows stay in the 50 MB L2) and with the L2 flushed before each call by
writing 128 MB ("cold": that write is not counted), beside chip_smoke.py's
row touch probe (V and nV read and written back at the admitted rows).
Prints each build's ptxas figures for the dim-8 instances, then one JSON
line per turn and one summary line (medians over the turns), with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_VARIANTS = ("default=default",
                    "ctas3_u4=kUpdateBatch=4",
                    "ctas4_u2=kRowCtasPerSm=4",
                    "ctas4_u4=kRowCtasPerSm=4,kUpdateBatch=4",
                    "nomath=patch:nomath", "nostore=patch:nostore")
TURNS = 2
# Diagnostic edits of the update: "nomath" drops the AdaGrad arithmetic
# (V -= g * eta0, nV as read), "nostore" keeps the loads and the math
# (their sum decides a store that never happens) but stores nothing.
PATCHES = {
    "nomath": [("""          const float eta = (V_lr_beta + sqrtf(ni)) / V_lr_eta;
          lanes_of(v2)[i] = vi - (gi + lambda_V * vi) / eta;""",
                """          lanes_of(v2)[i] = vi - gi * V_lr_eta;""")],
    "nostore": [("""        Vv[e[b]] = v2;
        nVv[e[b]] = n2;""", """        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < kW; ++i) sum += lanes_of(v2)[i] + lanes_of(n2)[i];
        if (sum == 12345.0f) {
          Vv[e[b]] = v2;
          nVv[e[b]] = n2;
        }""")],
}


def variant_source(src: str, edits: str) -> str:
    """The source with a variant's edits: constants (NAME=VALUE,...) or a
    diagnostic patch (patch:NAME)."""
    text = open(src).read()
    if edits == "default":
        return text
    pairs = (PATCHES[edits[6:]] if edits.startswith("patch:") else
             [(re.compile(rf"constexpr int {k} = \d+;"),
               f"constexpr int {k} = {v};")
              for k, v in (e.split("=") for e in edits.split(","))])
    for old, new in pairs:
        if isinstance(old, str):
            old = re.compile(re.escape(old))
        text, n = old.subn(lambda _: new, text)
        if n != 1:
            raise ValueError(f"edit {edits}: the source has changed")
    return text


def build(name: str, src: str, out_dir) -> tuple:
    """Start nvcc of src into out_dir/lib<name>.so with ptxas's report."""
    from wormhole_tpu_torch.ops import _cuda

    so = out_dir / f"lib{name}.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
           src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def ptxas_dim8(text: str) -> dict:
    """Registers and spill bytes of the dim-8 (dim_shift 3) instances of
    the two row kernels in ptxas's report."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"entry function '\w*?\d+((row_gather|v_update)_kernel)"
                      r"ILi3ELb(\d)E", line)
        if m:
            name = f"{m.group(1)}{'_bf16' if m.group(3) == '1' else ''}"
            continue
        if name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["regs"] = int(m.group(1))
        if name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(name, {})["spill"] = int(m.group(1))
    return out


def load(so) -> ctypes.CDLL:
    from wormhole_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(so))
    for fn in ("wh_row_tile_gather", "wh_v_scatter_update"):
        getattr(lib, fn).argtypes = _cuda._SIGNATURES["fused_update"][fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def bench_inputs(device) -> dict:
    """The DiFacto bench batch's V side, as chip_smoke.check_fm_kernels
    builds it: compact rows, vtouched, a random V, nV and gV."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from wormhole_tpu_torch.models.difacto import DifactoLearner

    lrn = DifactoLearner(cs.difacto_config("pallas"), device=device)
    for seg, idx, val, label, _ in cs.batches(cs.DENSE_BUCKETS, 2, seed=7):
        pk = lrn._pack_fm(lrn.make_device_batch(
            cs.to_rowblock(seg, idx, val, label)), train=True)
    ts_v, vtouched = pk[3], pk[4]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(13)
    uniq = dev(ts_v.uniq)
    return dict(uniq=uniq, vt=dev(vtouched),
                V=0.01 * torch.randn(cs.V_BUCKETS, cs.FM_DIM, generator=gen,
                                     device=device),
                nV=torch.rand(cs.V_BUCKETS, cs.FM_DIM, generator=gen,
                              device=device),
                gV=torch.randn(uniq.numel(), cs.FM_DIM, generator=gen,
                               device=device),
                n_rows=int((ts_v.uniq < cs.V_BUCKETS).sum()),
                n_touched=int(vtouched.sum()))


def kernel_ms(fn, device, name: str, flush=None, iters: int = 20) -> float:
    """Device time of one call of fn, counting only the kernels whose
    name holds `name` (profiler), with flush() before each call if
    given."""
    import torch

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize(device)
    us = sum(cs._device_us(e) for e in prof.key_averages()
             if name in e.key
             and str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / 1e3 / iters


def run_variant(lib, x: dict, device, check: bool, patched: bool,
                flush) -> dict:
    import torch

    import chip_smoke as cs
    from wormhole_tpu_torch.ops import fused_update as fu

    dim, rows, u_cap = cs.FM_DIM, cs.V_BUCKETS, x["uniq"].numel()
    st = torch.cuda.current_stream(device).cuda_stream
    hyper = (0.01, 1.0, 0.01)
    out = torch.empty(u_cap, dim, device=device)

    def gather():
        rc = lib.wh_row_tile_gather(x["V"].data_ptr(), x["uniq"].data_ptr(),
                                    out.data_ptr(), u_cap, rows, 3, 0, st)
        if rc:
            raise RuntimeError(f"row_tile_gather: CUDA error {rc}")

    def update(V, nV):
        rc = lib.wh_v_scatter_update(
            V.data_ptr(), nV.data_ptr(), x["gV"].data_ptr(),
            x["vt"].data_ptr(), x["uniq"].data_ptr(), u_cap, rows, 3, 0,
            *hyper, st)
        if rc:
            raise RuntimeError(f"v_scatter_update: CUDA error {rc}")

    if check and not patched:
        gather()
        want = fu.row_tile_gather_plain(x["V"], x["uniq"], dim, torch.float32)
        if not torch.equal(out, want):
            raise AssertionError("row_tile_gather differs from plain")
        Vk, nVk, Vp, nVp = (x["V"].clone(), x["nV"].clone(),
                            x["V"].clone(), x["nV"].clone())
        update(Vk, nVk)
        fu.v_scatter_update_plain(Vp, nVp, x["gV"], x["vt"], x["uniq"],
                                  dim=dim, V_lr_eta=hyper[0],
                                  V_lr_beta=hyper[1], lambda_V=hyper[2],
                                  dtype=torch.float32)
        cs.compare("v_scatter_update V", Vk, Vp, 1e-5, 1e-6)
        cs.compare("v_scatter_update nV", nVk, nVp, 1e-5, 1e-6)
    Vk, nVk = x["V"].clone(), x["nV"].clone()
    return {"row_tile_gather": kernel_ms(gather, device, "row_gather"),
            "v_scatter_update": kernel_ms(lambda: update(Vk, nVk), device,
                                          "v_update"),
            "row_tile_gather_cold": kernel_ms(gather, device, "row_gather",
                                              flush),
            "v_scatter_update_cold": kernel_ms(lambda: update(Vk, nVk),
                                               device, "v_update", flush)}


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("v_row_lab: CUDA is not available", file=sys.stderr)
        return 2
    from wormhole_tpu_torch.ops import _cuda

    other = None
    if argv[:1] == ["--other"]:
        other, argv = argv[1], argv[2:]
    specs = argv or list(DEFAULT_VARIANTS)
    out_dir = _cuda.BUILD_DIR / "v_row_lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = str(_cuda.CSRC / "fused_update.cu")
    procs, patched = {}, set()
    for spec in specs:
        name, edits = spec.split("=", 1)
        vsrc = out_dir / f"{name}.cu"
        vsrc.write_text(variant_source(src, edits))
        procs[name] = build(name, str(vsrc), out_dir)
        if edits.startswith("patch:"):
            patched.add(name)
    if other:
        procs["other"] = build("other", os.path.join(
            other, "wormhole_tpu_torch/csrc/fused_update.cu"), out_dir)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{text}")
        print(f"[ptxas] {name}: {json.dumps(ptxas_dim8(text))}", flush=True)
        libs[name] = load(so)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    import chip_smoke as cs

    probe_build = cs.start_probe_build()
    device = torch.device("cuda", 0)
    x = bench_inputs(device)
    probe = cs.finish_probe_build(*probe_build)
    big = torch.empty(1 << 25, device=device)
    flush = big.zero_
    Vp, nVp = x["V"].clone(), x["nV"].clone()
    adm = x["uniq"][(x["uniq"] < cs.V_BUCKETS) & (x["vt"] > 0)].contiguous()
    st = torch.cuda.current_stream(device).cuda_stream

    def touch():
        rc = probe.wh_touch_rows(Vp.data_ptr(), nVp.data_ptr(),
                                 adm.data_ptr(), adm.numel(), 2, st)
        if rc:
            raise RuntimeError(f"touch_rows: CUDA error {rc}")
    print(f"[lab] {smi}; u_cap {x['uniq'].numel()}, {x['n_rows']} rows, "
          f"{x['n_touched']} admitted", flush=True)
    order = list(libs) + ["touch_probe"]
    times = {n: [] for n in order}
    for turn in range(TURNS):
        for name in (order if turn % 2 == 0 else order[::-1]):
            if name == "touch_probe":
                got = {"v_scatter_update": kernel_ms(touch, device,
                                                     "touch_rows"),
                       "v_scatter_update_cold": kernel_ms(
                           touch, device, "touch_rows", flush)}
            else:
                got = run_variant(libs[name], x, device, turn == 0,
                                  name in patched, flush)
            times[name].append(got)
            print(json.dumps({"turn": turn, "variant": name, **got}),
                  flush=True)
    summary = {n: {k: statistics.median(t[k] for t in ts) for k in ts[0]}
               for n, ts in times.items()}
    print(f"[lab] {smi}: " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
