"""Declared service-level objectives and their error-budget burn.

The port's copy of the JAX package's obs/slo.py, renamed to this
package and sharing nothing with it.

An SLO here is a target over the metrics the registry already
collects — no new instrumentation, just judgement: a latency SLO says
"p99 of this histogram stays under X ms", an error SLO says "the bad
fraction of these counters stays under budget B". ``evaluate`` turns a
snapshot into verdicts with a *burn rate* — observed violation divided
by allowance — so 1.0 is exactly on budget, >1 is violated, and the
number stays comparable as targets are tuned via their knobs
(WH_SLO_*, group "obs").

Burn semantics per kind:

- latency: the reservoir fraction of observations above the target,
  over an implied 1% allowance (a p99 objective tolerates 1% slow
  requests by definition). observed = the p99 itself, in ms.
- errors: bad / (good + bad) over the configured budget fraction.
  observed = the error rate.

``evaluate`` also publishes each burn as a ``slo.<name>_burn`` gauge,
so burn rates ride heartbeats, the Prometheus endpoint, and the
ring-buffer history like any other metric. The run report and the
serve/chaos labs assert on these verdicts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from wormhole_tpu_torch.config import knob_value
from wormhole_tpu_torch.obs import metrics as _obs


@dataclasses.dataclass(frozen=True)
class SLO:
    name: str            # short id; gauge is slo.<name>_burn
    kind: str            # "latency" | "errors"
    doc: str
    hist: str = ""       # latency: histogram name
    target_knob: str = ""  # latency: knob holding the p99 target (ms)
    good: str = ""       # errors: counter of attempts that succeeded
    bad: str = ""        # errors: counter of failures
    budget_knob: str = ""  # errors: knob holding the allowed bad fraction


#: every declared objective; labs and the run report iterate this
SLOS: tuple[SLO, ...] = (
    SLO(name="serve.latency", kind="latency",
        hist="serve.latency_s", target_knob="WH_SLO_SERVE_P99_MS",
        doc="router predict p99 under WH_SLO_SERVE_P99_MS"),
    SLO(name="serve.errors", kind="errors",
        good="serve.router.requests", bad="serve.router.failures",
        budget_knob="WH_SLO_SERVE_ERR_BUDGET",
        doc="router failure fraction under WH_SLO_SERVE_ERR_BUDGET"),
    SLO(name="ps.rpc", kind="latency",
        hist="ps.client.rpc_s", target_knob="WH_SLO_PS_RPC_P99_MS",
        doc="PS client RPC p99 under WH_SLO_PS_RPC_P99_MS"),
)

_LATENCY_ALLOWANCE = 0.01  # a p99 objective tolerates 1% slow requests


def _knob_values() -> dict[str, float]:
    # literal reads so the env-knobs checker can statically tie each
    # declared WH_SLO_* knob to its read site
    return {
        "WH_SLO_SERVE_P99_MS": float(knob_value("WH_SLO_SERVE_P99_MS")),
        "WH_SLO_SERVE_ERR_BUDGET":
            float(knob_value("WH_SLO_SERVE_ERR_BUDGET")),
        "WH_SLO_PS_RPC_P99_MS": float(knob_value("WH_SLO_PS_RPC_P99_MS")),
    }


def _eval_latency(s: SLO, snap: dict) -> Optional[dict]:
    h = (snap.get("hists") or {}).get(s.hist)
    if not isinstance(h, dict) or not h.get("count"):
        return None
    target_ms = _knob_values()[s.target_knob]
    res = [float(x) for x in (h.get("res") or ())]
    if not res:
        return None
    over = sum(1 for x in res if x * 1e3 > target_ms) / len(res)
    p99 = _obs.hist_quantile(h, 0.99)
    return {
        "objective": f"p99 <= {target_ms:g} ms",
        "observed": round(float(p99) * 1e3, 3) if p99 is not None else None,
        "burn": round(over / _LATENCY_ALLOWANCE, 3),
        "count": int(h["count"]),
    }


def _eval_errors(s: SLO, snap: dict) -> Optional[dict]:
    counters = snap.get("counters") or {}
    good = int(counters.get(s.good, 0))
    bad = int(counters.get(s.bad, 0))
    total = good + bad
    if total == 0:
        return None
    budget = _knob_values()[s.budget_knob]
    rate = bad / total
    return {
        "objective": f"error rate <= {budget:g}",
        "observed": round(rate, 6),
        "burn": round(rate / budget, 3) if budget > 0 else
        (0.0 if bad == 0 else float("inf")),
        "count": total,
    }


def evaluate(snap: dict, publish: bool = True) -> list[dict]:
    """Judge every declared SLO against a snapshot. Objectives with no
    data (histogram never observed, zero attempts) are skipped — a
    training-only run doesn't fail the serving SLOs. When ``publish``,
    each burn also lands in the local registry as a slo.*_burn gauge."""
    out = []
    for s in SLOS:
        got = _eval_latency(s, snap) if s.kind == "latency" \
            else _eval_errors(s, snap)
        if got is None:
            continue
        verdict = {"name": s.name, "kind": s.kind, **got}
        verdict["ok"] = verdict["burn"] <= 1.0
        out.append(verdict)
        if publish:
            _obs.REGISTRY.gauge(f"slo.{s.name}_burn").set(verdict["burn"])
    return out


def format_lines(slos: list[dict]) -> list[str]:
    """Human lines for the run report / lab output."""
    lines = []
    for v in slos:
        mark = "ok" if v["ok"] else "VIOLATED"
        lines.append(
            f"  slo {v['name']:<14} {v['objective']:<28} "
            f"observed={v['observed']:g} burn={v['burn']:g} [{mark}]")
    return lines
