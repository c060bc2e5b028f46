"""The port's wire, retry, overload and fault layers against the JAX
package's: frames byte for byte under every encoding and compression
mode, each package decoding the other's frames, the retry backoff
sequence under one seeded ``random``, the AIMD admission walk, deadline
shedding, fault specs parsed the same, and the knob registry declared
the same."""

import dataclasses
import io
import random
import time

import numpy as np
import pytest

from wormhole_tpu import config as jconfig
from wormhole_tpu.runtime import faults as jfaults
from wormhole_tpu.runtime import net as jnet
from wormhole_tpu.runtime import overload as joverload
from wormhole_tpu.runtime import retry as jretry
from wormhole_tpu_torch import config as tconfig
from wormhole_tpu_torch.runtime import faults as tfaults
from wormhole_tpu_torch.runtime import net as tnet
from wormhole_tpu_torch.runtime import overload as toverload
from wormhole_tpu_torch.runtime import retry as tretry

PKGS = {"jax": jnet, "port": tnet}


def _arrays(net, enc):
    """Seeded float tables (1-D and 2-D, one past the compression floor)
    and the i32/i64 key arrays, sorted and not, in encoding ``enc``."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=3000).astype(np.float32)
    V = (rng.normal(size=(300, 8)) * 0.1).astype(np.float32)
    out = {"k32": np.sort(rng.integers(0, 1 << 20, 2000)).astype(np.int32),
           "k64": np.sort(rng.integers(0, 1 << 40, 700)).astype(np.int64),
           "shuf": rng.integers(0, 1 << 20, 300).astype(np.int32),
           "tiny": np.arange(5, dtype=np.float32)}
    if enc in ("int4", "int4r", "int8r"):
        base = enc[:4]
        out["w"] = net.quantize_rows(w, base)
        out["V"] = net.quantize_rows(V, base, per_row=enc.endswith("r"))
    else:
        out["w"], out["V"] = w, V
    return out


ENCODINGS = {"raw": 0, "bf16": 2, "int8": 1, "int4": 0, "int4r": 0,
             "int8r": 0}


def _frame(net, enc, comp):
    buf = io.BytesIO()
    hdr = {"op": "fetch", "sender": "r:0:1", "seq": 3, "tables": ["w"],
           "version": 2}
    n = net.send_frame(buf, hdr, _arrays(net, enc),
                       fixed_bytes=ENCODINGS[enc], compress=comp)
    return buf.getvalue(), n


@pytest.mark.parametrize("comp", [False, "zlib", "bshuf"],
                         ids=["plain", "zlib", "bshuf"])
@pytest.mark.parametrize("enc", list(ENCODINGS))
def test_frames_equal_byte_for_byte(enc, comp):
    jb, jn = _frame(jnet, enc, comp)
    tb, tn = _frame(tnet, enc, comp)
    assert jn == tn == len(jb)
    assert jb == tb


@pytest.mark.parametrize("comp", [False, "bshuf"], ids=["plain", "bshuf"])
@pytest.mark.parametrize("enc", ["raw", "bf16", "int8", "int4r"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_decodes_the_others_frames(writer, reader, enc, comp):
    blob, _ = _frame(PKGS[writer], enc, comp)
    got_h, got_a, total = PKGS[reader].recv_frame(io.BytesIO(blob))
    want_h, want_a, _ = PKGS[writer].recv_frame(io.BytesIO(blob))
    assert total == len(blob)
    assert got_h == want_h
    assert sorted(got_a) == sorted(want_a)
    for k in want_a:
        assert got_a[k].dtype == want_a[k].dtype
        assert np.array_equal(got_a[k], want_a[k]), k


def test_busy_and_shed_replies_match():
    assert tnet.busy_reply(12.5) == jnet.busy_reply(12.5)
    hdr = {"op": "fetch", "dl_mono": time.monotonic() - 1.0}
    assert toverload.shed_reply(hdr) == joverload.shed_reply(hdr)


@pytest.mark.parametrize("hint", [None, 0.02])
def test_retry_backoff_sequence_matches(monkeypatch, hint):
    """One seeded ``random`` gives both packages' budgets the same
    jittered, doubling, capped sleeps."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    seqs = []
    for mod in (jretry, tretry):
        slept.clear()
        random.seed(11)
        b = mod.RetryBudget(1000.0, base_s=0.05, cap_s=0.4, op="t")
        durs = [b.sleep(hint_s=hint) for _ in range(8)]
        assert durs == slept and b.attempts == 8
        seqs.append(durs)
    assert seqs[0] == seqs[1]
    if hint is None:
        assert max(seqs[0]) <= 0.4 * 1.5


def test_retry_policy_defaults_match(monkeypatch):
    monkeypatch.setenv("WH_RETRY_BASE_SEC", "0.03")
    monkeypatch.setenv("WH_RETRY_CAP_SEC", "0.7")
    jb = jretry.RetryPolicy(5.0, op="x").budget()
    tb = tretry.RetryPolicy(5.0, op="x").budget()
    assert (jb._base, jb._cap, jb.op) == (tb._base, tb._cap, tb.op) \
        == (0.03, 0.7, "x")


def _aimd_walk(mod):
    """Drive an adaptive gate through slow then fast windows; returns
    the limit after each completion and the final in-flight count."""
    gate = mod.AdmissionController(limit=8, adaptive=True, target_ms=10.0)
    trail = []
    rng = np.random.default_rng(3)
    for window in range(12):
        slow = window % 4 < 2
        held = 0
        while gate.try_enter("fetch"):
            held += 1
            if held > 64:
                break
        for _ in range(held):
            ms = (30.0 if slow else 2.0) + float(rng.random())
            gate.leave("fetch", ms / 1e3)
            trail.append(gate.limit)
        # a full window at the limit without violation adds one
        for _ in range(16):
            assert gate.try_enter("fetch")
            gate.leave("fetch", 0.001)
            trail.append(gate.limit)
    assert gate.try_enter("hello")  # control ops bypass the gate
    return trail, gate.inflight


def test_admission_aimd_steps_match():
    jt = _aimd_walk(joverload)
    tt = _aimd_walk(toverload)
    assert jt == tt
    steps = np.diff(jt[0])
    assert (steps < 0).any() and (steps > 0).any()  # backed off, climbed


@pytest.mark.parametrize("op,past", [("fetch", True), ("fetch", False),
                                     ("hello", True), ("score", True)])
def test_should_shed_matches(op, past):
    dl = time.monotonic() + (-0.5 if past else 60.0)
    for mod in (joverload, toverload):
        hdr = {"op": op, "dl_mono": dl}
        assert mod.should_shed(hdr) == (past and op != "hello")
    hdr = {"op": op, "dl": 0.25}
    jh, th = dict(hdr), dict(hdr)
    joverload.arm(jh)
    toverload.arm(th)
    assert abs(jh["dl_mono"] - th["dl_mono"]) < 0.05


SPECS = [
    ("server:1:kill@push:200", "server", 1, 0),
    ("server:1:kill@push:200", "server", 1, 1),
    ("server:0:kill@any:3:always", "server", 0, 2),
    ("worker:2:kill@allreduce:5", "worker", 2, 0),
    ("net:delay:ms=7,net:reset:after_frames=9", None, 0, 0),
    ("net:partition@fetch:1.5,net:slow@score:20", None, 0, 0),
    ("net:partition@fetch:1.5", "server", 0, 0),
    ("sched:drop@epoch:4,sched:kill@barrier:2", "scheduler", 0, 0),
]
_ARMED = ("_kills", "_wkills", "_delay_s", "_reset_after", "_drops",
          "_skills", "_partitions", "_slows")


@pytest.mark.parametrize("spec,role,rank,epoch", SPECS)
def test_fault_specs_parse_the_same(spec, role, rank, epoch):
    jf = jfaults.Faults(spec, role=role, rank=rank, epoch=epoch)
    tf = tfaults.Faults(spec, role=role, rank=rank, epoch=epoch)
    for a in _ARMED:
        assert getattr(jf, a) == getattr(tf, a), a


@pytest.mark.parametrize("spec", ["server:1", "net:delay:7",
                                  "net:bogus:1", "worker:0:kill@x:0"])
def test_bad_fault_specs_raise_in_both(spec):
    for mod in (jfaults, tfaults):
        with pytest.raises(mod.FaultSpecError):
            mod.Faults(spec, role="worker")


def test_declared_knobs_match_the_jax_registry():
    assert len(tconfig.KNOBS) > 30
    # the BSP ring's (runtime/allreduce.py)
    assert {"WH_BSP_STEP_TIMEOUT", "WH_BSP_RETRY_SEC"} <= set(tconfig.KNOBS)
    for name, knob in tconfig.KNOBS.items():
        assert dataclasses.astuple(knob) == \
            dataclasses.astuple(jconfig.KNOBS[name]), name


def test_every_knob_the_port_reads_is_declared():
    """Each `knob_value("WH_...")` in the port's sources names a knob of
    its registry (the PS plane's among them), so none fails at run time
    with a KeyError the CPU tests never reach."""
    import pathlib
    import re

    root = pathlib.Path(tconfig.__file__).parent
    read = set()
    for path in root.rglob("*.py"):
        read |= set(re.findall(r'knob_value\("(WH_[A-Z0-9_]+)"\)',
                               path.read_text()))
    assert {"WH_ELASTIC", "WH_ELASTIC_JOIN", "WH_ELASTIC_PLAN",
            "WH_SCHED_JOURNAL", "WH_OBS_RING", "WH_BSP_STEP_TIMEOUT",
            "WH_BSP_RETRY_SEC"} <= read
    assert read <= set(tconfig.KNOBS), sorted(read - set(tconfig.KNOBS))
    for name in ("WH_PS_RETRY_SEC", "WH_ASYNC_SYNC", "WH_KEYCACHE",
                 "WH_WIRE", "WH_WIRE_EF", "WH_WIRE_COMP", "WH_PS_PLANE",
                 "WH_SCHED_RETRY_SEC", "WH_SERVE_SNAPSHOT"):
        assert name in tconfig.KNOBS, name
