"""The port's wormsan CLI: replay findings from a dump dir, or run the
selftest.

    python -m wormhole_tpu_torch.wormsan --selftest
        Install the sanitizer in this process and run the three seeded
        fixtures (wormhole_tpu_torch/wormsan/fixtures.py); exit 0 iff
        every detector fired on its fixture with a usable stack.

    python -m wormhole_tpu_torch.wormsan [--stacks] [DIR]
        Pretty-print the san-*.jsonl findings a WH_SAN=1 run dumped into
        DIR (default: $WH_SAN_DUMP_DIR).  Exit 1 if any findings exist —
        usable directly as a CI / chaos_lab verdict.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _selftest() -> int:
    from wormhole_tpu_torch import wormsan
    from wormhole_tpu_torch.wormsan import fixtures

    wormsan.install(instrument=False)
    failed = []
    for detector, fixture in fixtures.ALL.items():
        before = {f["key"] for f in wormsan.findings()}
        fixture()
        new = [f for f in wormsan.findings()
               if f["detector"] == detector and f["key"] not in before]
        ok = bool(new) and all(
            any(s.strip() for s in f["stacks"].values()) for f in new)
        print(f"selftest[{detector}]: "
              f"{'PASS' if ok else 'FAIL'} ({len(new)} finding(s))")
        if not ok:
            failed.append(detector)
    if failed:
        print(f"selftest FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    print("selftest OK: all three detectors fired on their fixtures")
    return 0


def load_dump_dir(dump_dir: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dump_dir, "san-*.jsonl"))):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def _replay(dump_dir: str, stacks: bool) -> int:
    if not dump_dir:
        print("no dump dir: pass DIR or set WH_SAN_DUMP_DIR",
              file=sys.stderr)
        return 2
    if not os.path.isdir(dump_dir):
        print(f"not a directory: {dump_dir}", file=sys.stderr)
        return 2
    findings = load_dump_dir(dump_dir)
    if not findings:
        print(f"wormsan: no findings in {dump_dir}")
        return 0
    by_det: dict[str, list[dict]] = {}
    for f in findings:
        by_det.setdefault(f["detector"], []).append(f)
    for det in sorted(by_det):
        print(f"== {det} ({len(by_det[det])} finding(s))")
        for f in by_det[det]:
            print(f"  [{f.get('pid', '?')}/{f.get('thread', '?')}] "
                  f"{f['message']}")
            if stacks:
                for label, stk in f.get("stacks", {}).items():
                    if stk.strip():
                        print(f"  -- {label}:")
                        for line in stk.rstrip().splitlines():
                            print(f"     {line}")
    print(f"wormsan: {len(findings)} finding(s) in {dump_dir}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wormhole_tpu_torch.wormsan",
        description="runtime concurrency sanitizer: selftest and "
                    "finding replay")
    ap.add_argument("dump_dir", nargs="?",
                    default=os.environ.get("WH_SAN_DUMP_DIR", ""),
                    help="dump dir with san-*.jsonl findings "
                         "(default: $WH_SAN_DUMP_DIR)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded fixtures against the detectors")
    ap.add_argument("--stacks", action="store_true",
                    help="print captured stacks with each finding")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    return _replay(args.dump_dir, args.stacks)


if __name__ == "__main__":
    sys.exit(main())
