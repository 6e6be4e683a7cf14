"""Text rendering for `python -m repro.experiments trace <result.json>`.

`render_summary` takes a RunResult *dict* (the parsed JSON file, not the
reconstructed dataclass) so it can render any result artifact -- including
pre-metrics files, for which it says so instead of failing.
"""

from __future__ import annotations

__all__ = ["render_summary"]


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.4f} s"


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return f"{int(v):,}"


def _rows(pairs, indent="  ") -> list[str]:
    """Two-column aligned rows from (label, value) pairs."""
    pairs = [(str(k), str(v)) for k, v in pairs]
    if not pairs:
        return []
    width = max(len(k) for k, _ in pairs)
    return [f"{indent}{k:<{width}}  {v}" for k, v in pairs]


def render_summary(result: dict) -> str:
    """Render a phase-breakdown / counter / r-hat summary of one RunResult
    JSON dict (as written by `repro.experiments run --out` or
    `RunResult.to_json`)."""
    spec = result.get("spec", {})
    backend = result.get("backend", {})
    name = spec.get("name", "?")
    kind = backend.get("kind", "?")
    params = backend.get("params") or {}
    tag = kind + (f"/{params['engine']}" if "engine" in params else "")
    wall = result.get("wall_s")

    lines = [f"run {name!r}  backend={tag}  wall={_fmt_s(wall)}"]

    m = result.get("metrics")
    if m is None:
        lines.append("  (no metrics block -- result predates repro.obs)")
        return "\n".join(lines)

    # -- phase breakdown -----------------------------------------------------
    phase_rows = [("compile", m.get("compile_s")),
                  ("execute", m.get("execute_s"))]
    if m.get("eval_s") is not None:
        phase_rows.append(("eval", m.get("eval_s")))
    for pname, agg in sorted((m.get("phases") or {}).items()):
        if pname in ("compile", "execute", "eval"):
            continue
        phase_rows.append((pname, agg.get("total_s")))
    total = sum(v for _, v in phase_rows if v) or None
    lines.append("phases:")
    lines += _rows([
        (pname, _fmt_s(v) + (f"  ({100.0 * v / total:5.1f}%)"
                             if v is not None and total else ""))
        for pname, v in phase_rows])

    # -- counters ------------------------------------------------------------
    counter_rows = [("msgs", m.get("msgs")),
                    ("bytes_on_wire", m.get("bytes_on_wire")),
                    ("gossip_rounds", m.get("gossip_rounds")),
                    ("drops", m.get("drops")),
                    ("retunes", m.get("retunes"))]
    extra = sorted((m.get("counters") or {}).items(),
                   key=lambda kv: -abs(kv[1]))
    counter_rows += [(k, v) for k, v in extra[:8]
                     if k not in dict(counter_rows)]
    lines.append("counters:")
    lines += _rows([(k, _fmt_num(v)) for k, v in counter_rows])

    # -- fault injection -----------------------------------------------------
    faults = m.get("faults")
    if faults:
        lines.append("faults:")
        lines += _rows([(k, _fmt_num(v)) for k, v in sorted(faults.items())])

    # -- compression ---------------------------------------------------------
    comp = m.get("compression")
    if comp:
        lines.append("compression:")
        comp_rows = [("kind", comp.get("kind", "?")),
                     ("wire_ratio", _fmt_num(comp.get("wire_ratio"))),
                     ("bytes_saved", _fmt_num(comp.get("bytes_saved")))]
        rns = comp.get("residual_norms") or []
        if rns:
            comp_rows.append(
                ("ef_residual", f"{rns[0]:.4g} @ start -> "
                                f"{rns[-1]:.4g} @ end ({len(rns)} pts)"))
        lines += _rows(comp_rows)

    # -- step-time quantiles -------------------------------------------------
    q = m.get("step_time_quantiles")
    if q:
        lines.append(f"step times ({q.get('unit', '?')}-clock, "
                     f"n={q.get('n', '?')}):")
        lines += _rows([(p, f"{q[p]:.6g}")
                        for p in ("p50", "p90", "p99", "max") if p in q])

    # -- r-hat vs r ----------------------------------------------------------
    rhat_rows = [("configured r", spec.get("r"))]
    if m.get("r_hat") is not None:
        rhat_rows.append(("r̂ (controller)", m.get("r_hat")))
    meas = result.get("r_measurement") or {}
    if meas.get("r") is not None:
        rhat_rows.append(("r empirical", meas.get("r")))
    pred = result.get("predictions") or {}
    for key in ("h_opt", "n_opt", "tau_eps"):
        if pred.get(key) is not None:
            rhat_rows.append((f"{key} (predicted)", pred.get(key)))
    lines.append("r̂ vs r:")
    lines += _rows([(k, "-" if v is None else f"{v:.6g}"
                     if isinstance(v, float) else str(v))
                    for k, v in rhat_rows])

    # -- retune history ------------------------------------------------------
    hist = m.get("retune_history") or []
    if hist:
        lines.append("retunes:")
        lines += _rows([(f"t={from_t:g}",
                         f"h={int(h)}  (r̂={r_hat:.4g}, "
                         f"raw h_opt={h_opt_raw:.4g})")
                        for from_t, h, h_opt_raw, r_hat, _lam2 in hist])
    traj = m.get("r_hat_trajectory") or []
    if traj:
        t0, v0 = traj[0]
        t1, v1 = traj[-1]
        lines.append(f"r̂ trajectory: {len(traj)} samples, "
                     f"{v0:.4g} @ t={t0:g} -> {v1:.4g} @ t={t1:g}")
    return "\n".join(lines)
