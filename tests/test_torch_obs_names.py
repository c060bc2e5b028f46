"""The port's metric-name registry (wormhole_tpu_torch/obs/names.py)
against the port's emit sites, through the JAX package's lint checker
(tools/wormlint metric-names), read-only: every name the port emits is
registered, every registered name is emitted, and every name keeps the
dotted lowercase convention."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from wormlint import metricnames  # noqa: E402
from wormlint.core import FileSource  # noqa: E402

PORT = ROOT / "wormhole_tpu_torch"


def _port_sources():
    return [FileSource(str(p), p.read_text())
            for p in sorted(PORT.rglob("*.py"))]


def test_port_registry_matches_every_emit_site():
    findings = metricnames.check(_port_sources())
    assert not findings, [f.render() for f in findings]


@pytest.mark.parametrize("kind", ["counter", "histogram", "span"])
def test_the_check_sees_a_stray_name(kind):
    """The check is not vacuous: an emit of an unregistered name of each
    kind is a finding, and so is a registered name nothing emits."""
    emit = {"counter": '_obs.REGISTRY.counter("bsp.nothing_here")',
            "histogram": '_obs.REGISTRY.histogram("bsp.nothing_here_s")',
            "span": '_trace.span("bsp.nothing_here")'}[kind]
    files = _port_sources() + [FileSource("stray.py", emit + "\n")]
    keys = {f.key for f in metricnames.check(files)}
    assert f"unregistered:{kind}:bsp.nothing_here" + (
        "_s" if kind == "histogram" else "") in keys
    names = ROOT / "wormhole_tpu_torch" / "obs" / "names.py"
    text = names.read_text().replace(
        '    "bsp.rounds": ', '    "bsp.unused": "x",\n    "bsp.rounds": ', 1)
    files = [FileSource(str(names), text) if f.path == str(names) else f
             for f in _port_sources()]
    keys = {f.key for f in metricnames.check(files)}
    assert "unemitted:counter:bsp.unused" in keys


def test_bsp_names_are_registered():
    from wormhole_tpu_torch.obs import names

    for n in ("bsp.rounds", "bsp.ring_retries", "bsp.result_fetches",
              "bsp.checkpoints", "bsp.checkpoint_bytes", "bsp.recoveries"):
        assert n in names.COUNTERS
    for n in ("bsp.allreduce_s", "bsp.checkpoint_s"):
        assert n in names.HISTOGRAMS
    assert {"bsp.round", "bsp.peer.*"} <= set(names.SPANS)
