"""Controller decision-quality scoring from the audit trail.
Counterpart of `repro.monitor.quality`.

The `AuditTrail` (`repro_torch.telemetry.audit`) records what every Algorithm-2 decision saw
(the full PerfMon input vector), what it predicted (`mu_pred`,
`beta_e_pred`) and what then happened (`mu_real`, `beta_e_real`).
This module turns those records into judgments:

  * **prediction error** — |mu_pred - mu_real| per resolved decision:
    how good the paper's Eq. 4/5 occupancy model actually was online.
  * **decision cost** — the realized badness of the tick: occupancy
    past `cpu_max` (overload), plus a penalty for holding/throttling
    while the consumer demonstrably had headroom (overcaution).
  * **regret vs. do-nothing** — the controller's whole reason to
    exist is beating "always push".  `mu_pred` *is* the model's
    estimate of occupancy had the bucket been pushed, so for every
    hold/throttle the counterfactual push-cost is computable; regret
    is realized cost minus that baseline (negative = the controller
    beat do-nothing on this decision).
  * **per-decision score** in [0, 1] combining the above, attached to
    each `AuditRecord.quality`, and a per-run aggregate — the
    **controller score** that becomes a first-class `WorkloadReport`
    field.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# weights of the per-decision score: prediction error (z of cpu_max)
# and positive regret each subtract from a perfect 1.0
W_ERR = 1.0
W_REGRET = 1.0
# "demonstrable headroom": a hold/throttle is overcautious when the
# realized occupancy stayed under this fraction of cpu_max
HEADROOM_FRAC = 0.8


def _overload(mu: float, cpu_max: float) -> float:
    return max(0.0, mu - cpu_max) / max(cpu_max, 1e-9)


def score_record(rec, cpu_max: float = 0.55) -> Dict:
    """Score one `AuditRecord`; attaches and returns `rec.quality`.

    Unresolved records (a run ending mid-tick leaves the last decision
    open) are scored neutrally and flagged `resolved: False`.
    """
    held = rec.action in ("hold", "throttle")
    if rec.mu_real is None:
        q = {"resolved": False, "score": 1.0, "mu_abs_err": None,
             "cost": None, "baseline_cost": None, "regret": None,
             "overload": False, "overcautious": False}
        rec.quality = q
        return q

    mu_real = float(rec.mu_real)
    mu_pred = float(rec.mu_pred)
    err = abs(mu_pred - mu_real)

    over = _overload(mu_real, cpu_max)
    caution = 0.0
    if held and mu_real < HEADROOM_FRAC * cpu_max:
        caution = (HEADROOM_FRAC * cpu_max - mu_real) / max(cpu_max, 1e-9)
    cost = over + caution

    # do-nothing baseline: push this bucket regardless.  For pushes the
    # baseline IS the decision (regret only reflects anything the hold
    # machinery cost us: zero).  For holds/throttles the model's own
    # push prediction prices the counterfactual.
    baseline = _overload(mu_pred, cpu_max) if held else cost
    regret = cost - baseline

    score = max(0.0, min(1.0, 1.0 - W_ERR * err / max(cpu_max, 1e-9)
                         - W_REGRET * max(regret, 0.0)))
    q = {
        "resolved": True,
        "score": round(score, 4),
        "mu_abs_err": round(err, 4),
        "cost": round(cost, 4),
        "baseline_cost": round(baseline, 4),
        "regret": round(regret, 4),
        "overload": over > 0.0,
        "overcautious": caution > 0.0,
    }
    rec.quality = q
    return q


def score_trail(audit: List, cpu_max: float = 0.55) -> Dict:
    """Score every record in an audit trail and aggregate.

    Returns the per-run quality report: the mean per-decision score
    (the **controller score**), prediction-error stats, total/mean
    regret, and the overload/overcaution decision counts.  Safe on an
    empty trail (controller score 1.0: no decisions, no mistakes).
    """
    scores: List[float] = []
    errs: List[float] = []
    regrets: List[float] = []
    n_overload = n_overcautious = n_resolved = 0
    for rec in audit:
        q = score_record(rec, cpu_max)  # idempotent: pure f(record)
        scores.append(q["score"])
        if q["resolved"]:
            n_resolved += 1
            errs.append(q["mu_abs_err"])
            regrets.append(q["regret"])
            n_overload += bool(q["overload"])
            n_overcautious += bool(q["overcautious"])
    n = len(audit)
    mean = lambda xs: sum(xs) / len(xs) if xs else 0.0  # noqa: E731
    return {
        "decisions": n,
        "resolved": n_resolved,
        "controller_score": round(mean(scores), 4) if n else 1.0,
        "mu_err_mean": round(mean(errs), 4),
        "mu_err_max": round(max(errs), 4) if errs else 0.0,
        "regret_mean": round(mean(regrets), 4),
        "regret_total": round(sum(regrets), 4),
        "overload_decisions": n_overload,
        "overcautious_decisions": n_overcautious,
        "cpu_max": cpu_max,
    }


def per_action_scores(audit: List) -> Dict[str, Dict]:
    """Score breakdown by action kind (push/hold/throttle/drain+push);
    expects `score_trail` (or `score_record`) to have run first."""
    acc: Dict[str, List[float]] = {}
    for rec in audit:
        q = getattr(rec, "quality", None)
        if q is None or q["score"] is None:
            continue
        acc.setdefault(rec.action, []).append(q["score"])
    return {a: {"n": len(xs),
                "score_mean": round(sum(xs) / len(xs), 4),
                "score_min": round(min(xs), 4)}
            for a, xs in sorted(acc.items())}
