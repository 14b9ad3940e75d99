"""Render an events.jsonl into the human run summary table.

The port of erasurehead_tpu/obs/report.py: the same text for the same
records. ``python -m erasurehead_tpu_torch.cli report <events.jsonl>
[more.jsonl ...]``: one row per
run: scheme, real steps/sec, compile vs run seconds, exec/data cache hits,
straggler-arrival p50/p90/p99 (sentinel-masked, obs/events.arrival_summary)
and the mean AGC decode-error norm (obs/decode.py; exact schemes read 0).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence


def load_runs(paths: Sequence[str]) -> list[dict]:
    """Group event records by run_id across files, in first-seen order.

    Returns one dict per run: {"run_id", "start": run_start|None,
    "end": run_end|None, "compiles": [...], "uploads": [...],
    "rounds": [...], "decode": [...], "cohort": cohort|None,
    "warnings": [...], "prefetch": [...],
    "dispatch_ahead": dispatch_ahead|None,
    "stale_decode": stale_decode|None,
    "critical_path": critical_path|None, "regime": [...]}. A trailing
    run_id=None entry carries stray warnings, shard-store ``io`` records
    (out-of-core byte accounting), any ``sweep_trajectory`` journal
    records (a sweep journal is an events.jsonl like any other —
    `report` renders its rows, diverged ones flagged), the serve
    daemon's request/pack/admit/evict stream (rendered as the per-tenant
    serving section), un-run-tagged ``regime`` snapshots, the SLO
    tracker's ``slo`` burn-rate records, and the autotune plane's
    ``tune`` decision records (rendered as the tuned-defaults section).
    Unparseable lines are skipped (the validator's job is strictness;
    the report renders what it can)."""
    runs: dict = {}
    order: list = []
    warnings: list = []
    trajectories: list = []
    adapt: list = []
    membership: list = []
    fleet: list = []
    io: list = []
    regime: list = []
    slo: list = []
    tune: list = []
    serve: dict = {
        "requests": [], "packs": [], "admits": [], "evicts": [],
        "rejects": [], "streams": [], "restarts": [],
    }

    def run(rid):
        if rid not in runs:
            runs[rid] = {
                "run_id": rid, "start": None, "end": None, "compiles": [],
                "uploads": [], "rounds": [], "decode": [], "cohort": None,
                "warnings": [], "prefetch": [],
                "dispatch_ahead": None, "stale_decode": None,
                "critical_path": None, "regime": [],
            }
            order.append(rid)
        return runs[rid]

    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                rtype = rec.get("type")
                rid = rec.get("run_id")
                if rtype == "run_start":
                    run(rid)["start"] = rec
                elif rtype == "run_end":
                    run(rid)["end"] = rec
                elif rtype == "compile":
                    run(rid)["compiles"].append(rec)
                elif rtype == "data_upload":
                    run(rid)["uploads"].append(rec)
                elif rtype == "rounds":
                    run(rid)["rounds"].append(rec)
                elif rtype == "decode":
                    run(rid)["decode"].append(rec)
                elif rtype == "cohort":
                    run(rid)["cohort"] = rec
                elif rtype == "warning":
                    (run(rid)["warnings"] if rid else warnings).append(rec)
                elif rtype == "sweep_trajectory":
                    trajectories.append(rec)
                elif rtype == "adapt":
                    adapt.append(rec)
                elif rtype == "membership":
                    membership.append(rec)
                elif rtype == "fleet":
                    fleet.append(rec)
                elif rtype == "request":
                    serve["requests"].append(rec)
                elif rtype == "pack":
                    serve["packs"].append(rec)
                elif rtype == "admit":
                    serve["admits"].append(rec)
                elif rtype == "evict":
                    serve["evicts"].append(rec)
                elif rtype == "reject":
                    serve["rejects"].append(rec)
                elif rtype == "stream":
                    serve["streams"].append(rec)
                elif rtype == "restart":
                    serve["restarts"].append(rec)
                elif rtype == "prefetch":
                    run(rid)["prefetch"].append(rec)
                elif rtype == "dispatch_ahead":
                    run(rid)["dispatch_ahead"] = rec
                elif rtype == "stale_decode":
                    run(rid)["stale_decode"] = rec
                elif rtype == "critical_path":
                    run(rid)["critical_path"] = rec
                elif rtype == "regime":
                    (run(rid)["regime"] if rid else regime).append(rec)
                elif rtype == "slo":
                    slo.append(rec)
                elif rtype == "io":
                    io.append(rec)
                elif rtype == "tune":
                    tune.append(rec)
    out = [runs[rid] for rid in order]
    if (
        warnings or trajectories or adapt or membership or fleet or io
        or regime or slo or tune or any(serve.values())
    ):
        out.append({
            "run_id": None, "warnings": warnings,
            "trajectories": trajectories, "serve": serve,
            "adapt": adapt, "membership": membership, "fleet": fleet,
            "io": io, "regime": regime, "slo": slo, "tune": tune,
        })
    return out


def _adapt_section(stray: list) -> list[str]:
    """The adaptive-controller section: one line per decision (chunk
    start round, chosen arm, reason), plus a switch/shift summary — a
    run's policy trajectory, reconstructed from its `adapt` events."""
    decisions: list = []
    for g in stray:
        decisions.extend(g.get("adapt", []))
    if not decisions:
        return []
    switches = sum(
        1
        for a, b in zip(decisions, decisions[1:])
        if a.get("arm") != b.get("arm")
    )
    shifts = sum(1 for d in decisions if d.get("regime_shift"))
    lines = [
        f"\nadaptive controller: {len(decisions)} decision(s), "
        f"{switches} arm switch(es)"
        + (f", {shifts} regime shift(s) detected" if shifts else "")
    ]
    for d in decisions:
        err = d.get("decode_error_mean")
        lines.append(
            f"  round {d.get('round', '?'):>5} -> "
            f"{str(d.get('arm', '?'))[:24]:24s} [{d.get('reason', '?')}]"
            f"  sim/round={_fmt(d.get('sim_per_round'), '.4f')}"
            f"  decode_err={_fmt(err, '.6f')}"
            + ("  REGIME SHIFT" if d.get("regime_shift") else "")
        )
    return lines


def _membership_section(stray: list) -> list[str]:
    """The elastic-membership section: the run's membership timeline
    (deaths, joins, re-layouts, probes) plus a per-chunk row summary —
    the controller's trajectory, reconstructed from its `membership`
    events (elastic/driver.py)."""
    recs: list = []
    for g in stray:
        recs.extend(g.get("membership", []))
    if not recs:
        return []
    decisions = [r for r in recs if r.get("action") != "chunk"]
    chunks = [r for r in recs if r.get("action") == "chunk"]
    relayouts = [r for r in decisions if r.get("action") == "relayout"]
    deaths = [w for r in decisions if r.get("action") == "death"
              for w in (r.get("workers") or [])]
    joins = [w for r in decisions if r.get("action") == "join"
             for w in (r.get("workers") or [])]
    lines = [
        f"\nelastic membership: {len(chunks)} chunk(s), "
        f"{len(relayouts)} re-layout(s)"
        + (f", {len(deaths)} death(s) {sorted(set(deaths))}" if deaths
           else "")
        + (f", {len(joins)} join(s) {sorted(set(joins))}" if joins else "")
    ]
    for r in decisions:
        action = r.get("action", "?")
        detail = ""
        if r.get("workers"):
            detail = f" workers={r['workers']}"
        if action == "relayout":
            detail += (
                f"  {r.get('n_workers_before', '?')} -> "
                f"{r.get('n_workers', '?')} workers"
            )
        lines.append(
            f"  round {r.get('round', '?'):>5} {action:10s}{detail}"
        )
    for r in chunks:
        arm = r.get("arm")
        lines.append(
            f"  round {r.get('round', '?'):>5} chunk      "
            f"W={r.get('n_workers', '?'):<3} "
            f"sim={_fmt(r.get('sim_time'), '.3f'):>8s} "
            f"decode_err={_fmt(r.get('decode_error_mean'), '.6f')}"
            + (f" arm={arm}" if arm else "")
        )
    return lines


def _fleet_section(stray: list) -> list[str]:
    """The serve-fleet section: the fleet's membership and deploy
    timeline — joins, probe-miss streaks, deaths declared (with the
    evidential streak that earned them), WAL adoptions (and how many
    acceptances each replayed), routing redirects, and the deploy
    phases of each rolling bounce — from the typed `fleet` events
    (serve/fleet.py, serve/router.py)."""
    recs: list = []
    for g in stray:
        recs.extend(g.get("fleet", []))
    if not recs:
        return []
    by = {a: [r for r in recs if r.get("action") == a]
          for a in ("join", "suspect", "declare_dead", "adopt",
                    "route", "deploy_phase")}
    replayed = sum(int(r.get("records") or 0) for r in by["adopt"])
    lines = [
        f"\nserve fleet: {len(by['join'])} join(s), "
        f"{len(by['declare_dead'])} death(s) declared, "
        f"{len(by['adopt'])} adoption(s)"
        + (f" ({replayed} acceptance(s) replayed)" if by["adopt"]
           else "")
        + (f", {len(by['route'])} redirect(s)" if by["route"] else "")
    ]
    for r in recs:
        action = r.get("action", "?")
        if action == "probe":
            continue  # per-probe records are too chatty for the table
        detail = ""
        if action in ("suspect", "declare_dead"):
            detail = f" streak={r.get('streak', '?')}/{r.get('k', '?')}"
        elif action == "adopt":
            detail = (
                f" records={r.get('records', '?')}"
                + (f" adopter={r['adopter']}" if r.get("adopter")
                   else "")
            )
        elif action == "deploy_phase":
            detail = f" phase={r.get('phase', '?')}"
        elif action == "route":
            detail = f" hop={r.get('hop', '?')}"
        lines.append(
            f"  {action:13s} {str(r.get('replica', '?'))[:16]:16s}"
            f"{detail}"
        )
    return lines


def _pipeline_section(groups: list) -> list[str]:
    """The pipelined-training section: per pipelined run, how far ahead of
    the synchronous round barrier its dispatches ran (the overlap the
    pipeline bought on the simulated clock) and — when a tool emitted the
    post-run decomposition — whether staleness noise or erasure-coding
    noise dominated its decode error. From the ``dispatch_ahead`` and
    ``stale_decode`` records (parallel/pipeline.py, obs/decode.py)."""
    pipelined = [
        g for g in groups if g.get("dispatch_ahead") or g.get("stale_decode")
    ]
    if not pipelined:
        return []
    lines = ["\npipelined training (bounded staleness):"]
    for g in pipelined:
        da = g.get("dispatch_ahead") or {}
        sd = g.get("stale_decode") or {}
        line = f"  {str(g['run_id'])[:16]:16s}"
        if da:
            line += (
                f" depth={da.get('pipeline_depth', '?')}"
                f" ahead mean/max "
                f"{_fmt(da.get('ahead_mean_s'), '.4f')}/"
                f"{_fmt(da.get('ahead_max_s'), '.4f')}s"
                f" overlap {_fmt(da.get('overlap_total_s'), '.3f')}s"
            )
        if sd:
            line += (
                f" | staleness err {_fmt(sd.get('staleness_error_mean'), '.6f')}"
                f" vs coding err {_fmt(sd.get('coding_error_mean'), '.6f')}"
                f" (staleness share {_fmt(sd.get('staleness_share'), '.3f')})"
            )
        lines.append(line)
    return lines


def _critical_path_section(groups: list) -> list[str]:
    """The wall-clock attribution section: per run carrying a
    ``critical_path`` record, both ledgers rendered by
    obs/critical_path.render_lines (simulated-clock straggler
    decomposition + host-wall decode/prefetch split)."""
    from erasurehead_tpu_torch.obs import critical_path as cpath_lib

    attributed = [g for g in groups if g.get("critical_path")]
    if not attributed:
        return []
    lines = ["\ncritical path (wall-clock attribution):"]
    for g in attributed:
        lines.append(f"  {str(g['run_id'])[:16]}:")
        lines.extend(
            "  " + ln for ln in cpath_lib.render_lines(g["critical_path"])
        )
    return lines


def _regime_section(groups: list, stray: list) -> list[str]:
    """The arrival-regime section: the estimator's emitted snapshots
    (obs/regime.py) — change-points flagged, latest rate/kind last."""
    recs = [r for g in groups for r in g.get("regime", [])]
    recs += [r for g in stray for r in g.get("regime", [])]
    if not recs:
        return []
    lines = ["\narrival regime (online estimate):"]
    for r in recs:
        flag = " <- SHIFT" if r.get("shifted") else ""
        lines.append(
            f"  round {r.get('round', '?'):>4} kind={r.get('kind', '?'):9s}"
            f" rate {_fmt(r.get('rate'), '.3f')}/s"
            f" tail {_fmt(r.get('tail_index'), '.2f')}"
            f" (n={r.get('n', 0)}){flag}"
        )
    return lines


def _slo_section(stray: list) -> list[str]:
    """The SLO burn-rate section: per-tenant time-to-last-row objective
    windows from the tracker's ``slo`` records (obs/exporter.py)."""
    recs = [r for g in stray for r in g.get("slo", [])]
    if not recs:
        return []
    latest: dict = {}
    for r in recs:
        latest[r.get("tenant")] = r
    lines = ["\nslo burn rate (time-to-last-row):"]
    for tenant in sorted(latest):
        r = latest[tenant]
        burn = float(r.get("burn_rate", 0.0))
        flag = " <- BURNING" if burn > 1.0 else ""
        lines.append(
            f"  {str(tenant):12s} slo {_fmt(r.get('slo_s'), '.2f')}s: "
            f"{r.get('breaches', 0)}/{r.get('window_requests', 0)} breached,"
            f" burn {burn:.2f}x budget{flag}"
        )
    return lines


def _tune_section(stray: list) -> list[str]:
    """The autotuned-defaults section: one line per distinct auto-knob
    resolution from the ``tune`` records — which race, on which device
    kind at which shape, what it chose and where the choice came from
    (a just-run race, the persisted decision cache, or the hardcoded
    fallback). The section that answers "which measured verdicts did
    this run actually lower under?"."""
    recs = [r for g in stray for r in g.get("tune", [])]
    if not recs:
        return []
    latest: dict = {}
    for r in recs:
        latest[(r.get("race"), r.get("device_kind"), r.get("shape"))] = r
    n_measured = sum(
        1 for r in latest.values() if r.get("source") in ("race", "cache")
    )
    lines = [
        f"\nautotuned defaults: {len(latest)} resolution(s), "
        f"{n_measured} from measured verdicts"
    ]
    for key in sorted(latest, key=lambda k: tuple(str(x) for x in k)):
        r = latest[key]
        lines.append(
            f"  {str(r.get('race', '?')):13s} -> "
            f"{str(r.get('choice', '?')):12s} "
            f"[{r.get('source', '?')}]  {r.get('device_kind', '?')}  "
            f"{r.get('shape', '?')}"
        )
    return lines


def _prefetch_section(groups: list, stray: list) -> list[str]:
    """The out-of-core streaming section: per streamed run, how many
    partition windows moved how many host→device bytes and how much of
    the transfer time compute hid; plus the shard-store disk totals —
    from the ``prefetch`` (per-run) and ``io`` (stray) records."""
    streamed = [g for g in groups if g.get("prefetch")]
    io = [r for g in stray for r in g.get("io", [])]
    if not streamed and not io:
        return []
    lines = ["\nout-of-core streaming (shard store + prefetch):"]
    for g in streamed:
        pf = g["prefetch"]
        total = sum(p.get("bytes", 0) for p in pf)
        fetch = sum(p.get("fetch_s") or 0.0 for p in pf)
        lines.append(
            f"  {str(g['run_id'])[:16]:16s} {len(pf)} window(s), "
            f"{total / (1 << 20):.1f} MiB staged, "
            f"fetch {fetch:.3f}s"
        )
    reads = [r for r in io if r.get("kind") == "shard_read"]
    writes = [r for r in io if r.get("kind") == "store_write"]
    if reads or writes:
        rb = sum(r.get("bytes", 0) for r in reads)
        wb = sum(r.get("bytes", 0) for r in writes)
        lines.append(
            f"  shard io: {len(reads)} read(s) {rb / (1 << 20):.1f} MiB, "
            f"{len(writes)} write(s) {wb / (1 << 20):.1f} MiB"
        )
    return lines


def _serve_section(stray: list) -> list[str]:
    """The per-tenant serving section: requests, packed-dispatch ratio,
    admission pressure, backpressure (rejects + retried-after-429
    acceptances), stream overflow drops, warm restarts, and
    quarantined/diverged rows — from the serve daemon's request/pack/
    admit/evict/reject/stream/restart + sweep_trajectory records."""
    serve = {
        "requests": [], "packs": [], "admits": [], "evicts": [],
        "rejects": [], "streams": [], "restarts": [],
    }
    trajectories: list = []
    for g in stray:
        for k in serve:
            serve[k].extend((g.get("serve") or {}).get(k, []))
        trajectories.extend(g.get("trajectories", []))
    # completion markers (phase="done", server._finish) pair with intake
    # records for the live SLO/goodput plane; request totals here count
    # each request once, at intake
    serve["requests"] = [
        r for r in serve["requests"] if r.get("phase") != "done"
    ]
    if not serve["requests"] and not serve["packs"] and not (
        serve["rejects"] or serve["restarts"]
    ):
        return []
    packs = serve["packs"]
    n_packed_traj = sum(p.get("n_trajectories", 0) for p in packs)
    ratio = n_packed_traj / len(packs) if packs else 0.0
    deferred = sum(
        1 for a in serve["admits"] if a.get("admitted") is False
    )
    overflow_dropped = sum(
        s.get("dropped") or 0
        for s in serve["streams"]
        if s.get("event") == "overflow"
    )
    lines = [
        f"\nserve (multi-tenant cohort packing): "
        f"{len(serve['requests'])} request(s) -> {len(packs)} "
        f"dispatch(es), {ratio:.1f} trajectories/dispatch"
        + (f", {deferred} deferred by admission" if deferred else "")
        + (f", {len(serve['evicts'])} eviction(s)" if serve["evicts"]
           else "")
        + (f", {len(serve['rejects'])} rejected (429)"
           if serve["rejects"] else "")
    ]
    def _blank():
        return {
            "requests": 0, "rows": 0, "diverged": 0, "errors": 0,
            "rejects": 0, "retried": 0,
        }

    by_tenant: dict = {}
    for r in serve["requests"]:
        t = by_tenant.setdefault(r.get("tenant", "?"), _blank())
        t["requests"] += 1
        if r.get("retry"):
            # an acceptance whose submit attempt number is > 0: the
            # client's backoff schedule worked — count it as a retried
            # request that eventually got in
            t["retried"] += 1
    for r in serve["rejects"]:
        t = by_tenant.setdefault(r.get("tenant", "?"), _blank())
        t["rejects"] += 1
    for rec in trajectories:
        tenant = rec.get("tenant")
        if tenant is None:
            continue  # a local sweep journal row, not a serve row
        t = by_tenant.setdefault(tenant, _blank())
        t["rows"] += 1
        if rec.get("status") == "diverged":
            t["diverged"] += 1
    for w in (g2 for g in stray for g2 in g.get("warnings", [])):
        if w.get("kind") != "serve_error":
            continue
        msg = w.get("message", "")
        for tenant, t in by_tenant.items():
            if f"(tenant '{tenant}')" in msg:
                t["errors"] += 1
    header = (
        f"  {'tenant':16s} {'requests':>9s} {'rows':>6s} "
        f"{'diverged':>9s} {'errors':>7s} {'rejects':>8s} {'retried':>8s}"
    )
    lines += [header, "  " + "-" * (len(header) - 2)]
    for tenant in sorted(by_tenant):
        t = by_tenant[tenant]
        lines.append(
            f"  {tenant[:16]:16s} {t['requests']:>9d} {t['rows']:>6d} "
            f"{t['diverged']:>9d} {t['errors']:>7d} {t['rejects']:>8d} "
            f"{t['retried']:>8d}"
        )
    for r in serve["restarts"]:
        lines.append(
            f"  warm restart: {r.get('wal_records', 0)} WAL record(s) -> "
            f"{r.get('resubmitted', 0)} re-dispatched, "
            f"{r.get('rehydrated', 0)} rehydrated from journal"
        )
    if overflow_dropped:
        lines.append(
            f"  stream backpressure: {overflow_dropped} row(s) shed to "
            f"slow readers (journaled; re-fetchable by resubmission)"
        )
    return lines


def _fmt(v, spec: str, none: str = "-") -> str:
    return format(v, spec) if v is not None else none


def _arrival_cell(end: Optional[dict]) -> str:
    arr = (end or {}).get("arrival") or {}
    if arr.get("n_arrivals"):
        cell = (
            f"{_fmt(arr.get('p50'), '.3f')}/{_fmt(arr.get('p90'), '.3f')}"
            f"/{_fmt(arr.get('p99'), '.3f')}"
        )
        if arr.get("n_never"):
            cell += f" ({arr['n_never']} never)"
        return cell
    return "-"


def render(paths: Sequence[str]) -> str:
    """The summary table for one or more event logs."""
    loaded = load_runs(paths)
    groups = [g for g in loaded if g["run_id"] is not None]
    stray = [g for g in loaded if g["run_id"] is None]
    header = (
        f"{'run':16s} {'scheme':16s} {'steps/s':>9s} {'compile_s':>10s} "
        f"{'run_s':>8s} {'exec h/m':>9s} {'data':>5s} "
        f"{'arrival p50/p90/p99':>22s} {'decode err':>11s}"
    )
    lines = [header, "-" * len(header)]
    for g in groups:
        start, end = g["start"] or {}, g["end"] or {}
        scheme = start.get("scheme", "?")
        compile_s = sum(
            c.get("seconds", 0.0) for c in g["compiles"]
            if not c.get("cache_hit")
        )
        hits = end.get("exec_hits")
        misses = end.get("exec_misses")
        hm = f"{hits}/{misses}" if hits is not None else "-"
        data = "-"
        if g["uploads"]:
            data = "hit" if all(
                u.get("cache_hit") for u in g["uploads"]
            ) else "miss"
        err = end.get("decode_error_mean")
        if err is None and g["decode"]:
            # layer-tagged records are per-layer gradient-space series
            # (blockwise coding), not the run-level weight-space norm —
            # averaging them in would mix the two metrics
            untagged = [d for d in g["decode"] if d.get("layer") is None]
            n = sum(d.get("n_rounds", 0) for d in untagged)
            if n:
                err = sum(
                    d.get("error_mean", 0.0) * d.get("n_rounds", 0)
                    for d in untagged
                ) / n
        lines.append(
            f"{str(g['run_id'])[:16]:16s} {str(scheme)[:16]:16s} "
            f"{_fmt(end.get('steps_per_sec'), '9.1f'):>9s} "
            f"{compile_s:10.3f} "
            f"{_fmt(end.get('wall_time_s'), '8.3f'):>8s} {hm:>9s} "
            f"{data:>5s} {_arrival_cell(end):>22s} "
            f"{_fmt(err, '11.6f'):>11s}"
        )
    cohorts = [g for g in groups if g.get("cohort")]
    if cohorts:
        lines.append("\ncohort dispatches (trajectory-batched sweeps):")
        for g in cohorts:
            c = g["cohort"]
            schemes = c.get("schemes") or []
            seeds = c.get("seeds") or []
            disp = c.get("dispatches", 1)
            lines.append(
                f"  {str(g['run_id'])[:16]:16s} "
                f"{len(schemes)} scheme(s) x {len(set(seeds))} seed(s) = "
                f"{c.get('n_trajectories', len(seeds))} trajectories in "
                f"{disp} dispatch(es) [{c.get('lowering', '?')}]"
            )
    lines.extend(_critical_path_section(groups))
    lines.extend(_pipeline_section(groups))
    lines.extend(_prefetch_section(groups, stray))
    lines.extend(_regime_section(groups, stray))
    lines.extend(_serve_section(stray))
    lines.extend(_slo_section(stray))
    lines.extend(_tune_section(stray))
    lines.extend(_adapt_section(stray))
    lines.extend(_membership_section(stray))
    lines.extend(_fleet_section(stray))
    # serve rows (tenant-tagged) render in the serving section above; the
    # journal listing keeps the local-sweep rows
    trajectories = [
        t
        for g in stray
        for t in g.get("trajectories", [])
        if t.get("tenant") is None
    ]
    if trajectories:
        n_div = sum(1 for t in trajectories if t.get("status") == "diverged")
        lines.append(
            f"\nsweep journal: {len(trajectories)} trajectory record(s)"
            + (f", {n_div} DIVERGED" if n_div else "")
        )
        for t in trajectories:
            row = t.get("row") or {}
            loss = row.get("final_train_loss")
            status = t.get("status", "?")
            lines.append(
                f"  {str(t.get('label', '?'))[:24]:24s} "
                f"{status:>9s} "
                f"final_train_loss={_fmt(loss, '.6f') if isinstance(loss, (int, float)) else '-'}"
            )
    n_warn = sum(len(g["warnings"]) for g in groups) + sum(
        len(g["warnings"]) for g in stray
    )
    if n_warn:
        lines.append(f"\n{n_warn} warning(s):")
        for g in groups + stray:
            for w in g["warnings"]:
                lines.append(
                    f"  [{w.get('kind', '?')}] {w.get('message', '')}"
                )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``cli report`` / ``python -m erasurehead_tpu_torch.obs.report``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="erasurehead-tpu-torch report",
        description="Render events.jsonl run telemetry into a summary table",
    )
    p.add_argument("events", nargs="+", help="events.jsonl path(s)")
    p.add_argument("--validate", action="store_true",
                   help="schema-check the files first (exit 1 on errors)")
    ns = p.parse_args(argv)
    if ns.validate:
        from erasurehead_tpu_torch.obs import events as events_lib

        errors = [
            f"{path}: {e}"
            for path in ns.events
            for e in events_lib.validate_file(path)
        ]
        if errors:
            for e in errors:
                print(e)
            return 1
    print(render(ns.events))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
