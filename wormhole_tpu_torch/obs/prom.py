"""Prometheus text exposition (version 0.0.4) over metrics snapshots.

The port's copy of the JAX package's obs/prom.py, renamed to this
package and sharing nothing with it.

Renders the registry's JSON-able snapshot form — the same dict that
rides heartbeats and merges in the scheduler — as the plain-text
format every Prometheus-compatible scraper speaks. Pure string
assembly, no deps:

- counters become ``wh_<name>_total`` with ``# TYPE ... counter``;
- gauges become ``wh_<name>`` with ``# TYPE ... gauge``;
- histograms become summaries: ``{quantile="..."}``` sample lines
  estimated from the reservoir, plus ``_sum`` and ``_count``.

Name mangling: dotted registry names map to the Prometheus charset by
replacing every non-``[a-zA-Z0-9_]`` rune with ``_`` and prefixing
``wh_`` (``net.bytes_sent`` -> ``wh_net_bytes_sent``). Output is
sorted by metric name so consecutive scrapes diff cleanly and the
format golden test is deterministic.
"""

from __future__ import annotations

import re

from wormhole_tpu_torch.obs.metrics import hist_quantile

_QUANTILES = (0.5, 0.9, 0.99)
_BAD_RUNE = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    return "wh_" + _BAD_RUNE.sub("_", name)


def _num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_snapshot(snap: dict) -> str:
    """One scrape body from a snapshot dict ({"counters": ...,
    "gauges": ..., "hists": ...}); empty sections render nothing."""
    lines: list[str] = []
    for name, v in sorted((snap.get("counters") or {}).items()):
        m = prom_name(name) + "_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_num(v)}")
    for name, v in sorted((snap.get("gauges") or {}).items()):
        m = prom_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_num(v)}")
    for name, h in sorted((snap.get("hists") or {}).items()):
        if not isinstance(h, dict) or not h.get("count"):
            continue
        m = prom_name(name)
        lines.append(f"# TYPE {m} summary")
        for q in _QUANTILES:
            est = hist_quantile(h, q)
            if est is not None:
                lines.append(f'{m}{{quantile="{q}"}} {repr(float(est))}')
        lines.append(f"{m}_sum {repr(float(h.get('sum') or 0.0))}")
        lines.append(f"{m}_count {int(h['count'])}")
    return "\n".join(lines) + "\n" if lines else ""
