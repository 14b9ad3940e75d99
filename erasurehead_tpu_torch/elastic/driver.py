"""train_elastic_online: telemetry-driven elastic membership over the
chunked-restart seam.

The port of erasurehead_tpu/elastic/driver.py. ``parallel/failures.
train_elastic`` generalised to N restarts in either direction, with nothing
scripted: training runs in chunks through train()'s
``initial_state``/``initial_round`` contract (the seam adapt/driver.py
uses), and between chunks the
:class:`~erasurehead_tpu_torch.elastic.controller.MembershipController`
reads the chunk's OWN arrival telemetry to decide membership:

  - a worker whose ``-1`` never-arrived sentinel persists (or whose
    ``detect_dead`` timeout trips) for K consecutive rounds is declared
    dead; at the next chunk boundary the run re-lays the code onto the
    survivors (a fresh layout for W' through the scheme registry),
    params and momentum carried over, the resolved lr schedule continuous;
  - a collapsed arrival regime (the adapt/ shift rule) triggers a
    corroborated re-evaluation (a "probe");
  - a join offer (chaos ``worker_revive``, a scripted revive) scales the
    layout back UP the same way.

Chunks run under ``failures.plan_run(on_infeasible="failover",
timeout=...)``: a dead worker not yet detected costs failover rounds at the
master's ``timeout`` patience instead of the reference's hang-forever, the
cost signal that makes detection pay for itself.

Every decision and every finished chunk is a typed ``membership`` event:
``action="chunk"`` rows carry the chunk's science (sim clock, decode error,
params digest). The run is deterministic given (config, world, chaos env):
membership chaos is indexed by ABSOLUTE chunk boundary
(utils/chaos.membership_fires), detection is threshold-based, and the adapt
bandit (when composed) re-seeds per epoch. So a killed run REPLAYS: resumed
from the checkpoint and its aux sidecar, the finished chunks' rows
rehydrate bitwise from the journal and the rest recompute identically.

Across processes (``mesh=``, forwarded into every chunk's train(), as the
JAX driver does) every rank runs the same driver: membership reads only the
simulated clocks of the chunk's schedule (the ``detect_dead`` timeout
included), which every rank builds alike, and the chaos membership specs,
which fire by chunk boundary on every rank alike. With ``mesh=None`` an
epoch whose survivors no longer fold onto the world re-folds by train()'s
rule (29 survivors on 2 ranks run on 1; the other rank adds zeros). Rank 0
alone writes the journal and the checkpoints; every rank restores them.

Deviations from the JAX driver: ``device=`` sits beside ``mesh=``;
``init_params`` (as train() takes it) replaces the first chunk's seeded
init; the params digest hashes the port's own float32 bytes, so it is
stable within the port (reruns, resumes) but never equal to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from erasurehead_tpu_torch.elastic.controller import (
    ElasticConfig,
    MembershipController,
    auto_survivor_config,
    default_join_offers,
)

#: journal file name inside the journal directory
JOURNAL_NAME = "elastic_journal.jsonl"

#: envelope fields excluded from the bitwise row-rehydration contract
#: (they are properties of the writing process, not of the science)
ROW_VOLATILE = ("seq", "t")


def science_fields(rec: Mapping) -> dict:
    """A journal record minus the per-process envelope: the part the
    kill -> resume bitwise invariance covers."""
    return {k: v for k, v in rec.items() if k not in ROW_VOLATILE}


@dataclasses.dataclass
class ElasticResult:
    """A merged TrainResult plus the membership decision record."""

    result: Any  # trainer.TrainResult over the full horizon
    #: controller decisions (death/join/relayout/probe dicts, in order)
    decisions: list
    #: one dict per layout epoch: start round, worker set, chosen s
    epochs: list
    #: per-chunk science rows (action="chunk" journal payloads, round
    #: order; on a resumed run the pre-resume prefix is REHYDRATED from the
    #: journal, not recomputed)
    rows: list
    #: adapt-bandit decisions across all epochs ([] without adapt_arms)
    arm_decisions: list
    journal_path: Optional[str]
    #: first round actually trained by THIS process (resume), else 0
    resumed_from: int


def _digest_tree(tree) -> str:
    """Deterministic content digest of a tree of tensors (host bytes)."""
    from erasurehead_tpu_torch.ops import blocks

    h = hashlib.sha256()
    for leaf in blocks.tree_leaves(tree):
        arr = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def _emit(logger, type_: str, **fields) -> None:
    """Emit into the driver's own journal (when open) AND the ambient
    capture (when installed)."""
    from erasurehead_tpu_torch.obs import events as obs_events

    if logger is not None:
        logger.emit(type_, **fields)
    obs_events.emit(type_, **fields)


def _apply_scripted(avail: np.ndarray, deaths, revives, W: int) -> None:
    """Scripted ground-truth availability: per-worker death/revive events
    applied in round order (a revive after a death re-opens the column)."""
    R = avail.shape[0]
    events: dict = {}
    for w, r in (deaths or {}).items():
        w, r = int(w), int(r)
        if not 0 <= w < W:
            raise ValueError(f"scripted death for worker {w} outside [0, {W})")
        events.setdefault(w, []).append((r, False))
    for w, r in (revives or {}).items():
        w, r = int(w), int(r)
        if not 0 <= w < W:
            raise ValueError(f"scripted revive for worker {w} outside [0, {W})")
        events.setdefault(w, []).append((r, True))
    for w, evs in events.items():
        for r, alive in sorted(evs):
            avail[max(r, 0):R, w] = alive


def _filter_arms(cfg_epoch, arms) -> list:
    """The registry-compatible subset of ``arms`` for this epoch's config:
    each arm must validate as a config AND build the same device data stack
    (adapt/driver._validate_arms). The epoch's own policy is always arm 0,
    so the bandit can never be left armless by a W' that invalidates every
    alternative."""
    from erasurehead_tpu_torch.adapt.controller import Arm
    from erasurehead_tpu_torch.adapt.driver import _validate_arms

    base = Arm(cfg_epoch.scheme.value, cfg_epoch.num_collect, cfg_epoch.deadline)
    out = [base]
    for arm in arms or ():
        if arm.label == base.label:
            continue
        try:
            _validate_arms(cfg_epoch, [arm])
        except ValueError:
            continue
        out.append(arm)
    return out


def _load_journal_rows(path: str) -> dict:
    """round -> science row for every ``action="chunk"`` membership record in
    the journal (the last record per round wins: a chunk re-run after a kill
    between its row and its checkpoint appends an identical duplicate)."""
    rows: dict = {}
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # one torn final line after a kill is expected
            if (
                isinstance(rec, dict)
                and rec.get("type") == "membership"
                and rec.get("action") == "chunk"
                and isinstance(rec.get("round"), int)
            ):
                rows[rec["round"]] = science_fields(rec)
    return rows


def train_elastic_online(
    cfg,
    dataset,
    *,
    elastic: Optional[ElasticConfig] = None,
    device=None,
    arrivals: Optional[np.ndarray] = None,
    deaths: Optional[Mapping[int, int]] = None,
    revives: Optional[Mapping[int, int]] = None,
    survivor_overrides: Optional[dict] = None,
    adapt_arms: Optional[Sequence] = None,
    journal_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    init_params=None,
    mesh=None,
):
    """Train ``cfg.rounds`` rounds with ONLINE membership (module docstring).

    ``deaths``/``revives`` script the ground-truth world (``{worker:
    round}``: what actually happens to the cluster); the controller only
    ever sees the resulting telemetry. Chaos ``worker_death``/
    ``worker_revive`` specs (utils/chaos.py) change the same world at chunk
    boundaries. ``adapt_arms`` composes the adapt/ bandit: within each
    membership epoch it re-chooses the collection policy per chunk over the
    arms compatible with that epoch's layout-stack signature (a fresh,
    re-seeded controller per epoch). ``journal_dir`` appends the typed
    membership stream to ``elastic_journal.jsonl``; ``checkpoint_dir`` +
    ``resume=True`` restart from the latest checkpoint with the controller
    ledger restored from its aux sidecar. ``device`` defaults to ``cuda``;
    ``init_params`` replaces the first chunk's seeded init; ``mesh`` (None:
    train()'s rule, per epoch) is every chunk's worker mesh."""
    from erasurehead_tpu_torch import schemes
    from erasurehead_tpu_torch.adapt.controller import (
        AdaptiveController,
        ChunkStats,
        ControllerConfig,
    )
    from erasurehead_tpu_torch.adapt.driver import _cat_history
    from erasurehead_tpu_torch.models.glm import params_from_numpy
    from erasurehead_tpu_torch.obs import events as obs_events
    from erasurehead_tpu_torch.parallel import backend, failures
    from erasurehead_tpu_torch.train import checkpoint as ckpt_lib
    from erasurehead_tpu_torch.train import optimizer, trainer
    from erasurehead_tpu_torch.utils import chaos as chaos_lib
    from erasurehead_tpu_torch.utils.device import resolve_device

    ecfg = elastic or ElasticConfig()
    if cfg.arrival_mode != "simulated":
        raise ValueError(
            "train_elastic_online drives the scan trainer in chunks; "
            "arrival_mode='measured' has no chunked implementation"
        )
    if schemes.get(cfg.scheme).partial:
        raise ValueError(
            f"scheme {cfg.scheme.value!r}: partial two-part layouts "
            "structurally require every worker's uncoded first-part — "
            "neither failover rounds nor a W' re-layout exist for them"
        )
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    dev = resolve_device(device)

    R, W = cfg.rounds, cfg.n_workers
    base_arr = np.asarray(
        arrivals if arrivals is not None else trainer.default_arrivals(cfg),
        dtype=np.float64,
    )
    if base_arr.shape != (R, W):
        raise ValueError(f"arrivals shape {base_arr.shape} != ({R}, {W})")
    avail = np.ones((R, W), dtype=bool)
    _apply_scripted(avail, deaths, revives, W)
    lr_full = cfg.resolve_lr_schedule()
    chunk = ecfg.chunk_rounds

    def apply_boundary_chaos(lo: int) -> list:
        """Change the world per the chaos membership specs firing at this
        boundary; returns the revive offers. Indexed by ABSOLUTE boundary
        so resumed runs replay rather than fire again."""
        b = lo // chunk + 1
        for w in chaos_lib.membership_fires("worker_death", b):
            if not 0 <= w < W:
                raise ValueError(f"chaos worker_death id {w} outside [0, {W})")
            avail[lo:, w] = False
        offers = []
        for w in chaos_lib.membership_fires("worker_revive", b):
            if not 0 <= w < W:
                raise ValueError(f"chaos worker_revive id {w} outside [0, {W})")
            avail[lo:, w] = True
            offers.append(int(w))
        return offers

    # ---- journal + resume state ---------------------------------------------
    journal_path = None
    logger = None
    writer = backend.is_writer()
    if journal_dir:
        journal_path = os.path.join(journal_dir, JOURNAL_NAME)
        if writer:
            logger = obs_events.EventLogger(journal_path, mode="a")

    mem = MembershipController(W, ecfg)
    state = None
    start_round = 0
    bandit_state = None
    timeset = np.zeros(R)
    wt = np.full((R, W), -1.0)
    col = np.zeros((R, W), dtype=bool)
    derr = np.zeros(R)
    rows: list = []
    n_train_min: Optional[int] = None

    if resume:
        model = trainer.build_model(cfg)
        if init_params is None:
            template = model.init_params(cfg.seed, dataset.n_features, dev)
        else:
            template = params_from_numpy(init_params, dev)
        restored = ckpt_lib.restore_latest_with_aux(
            checkpoint_dir, optimizer.init_state(template, cfg.update_rule)
        )
        if restored is not None:
            state, start_round, _path, aux = restored
            mem = MembershipController.restore(aux["controller"], ecfg)
            bandit_state = aux.get("bandit")
            n_train_min = aux.get("n_train_min")
            timeset[:start_round] = np.asarray(aux["timeset"], dtype=np.float64)
            wt[:start_round] = np.asarray(aux["wt"], dtype=np.float64)
            col[:start_round] = np.asarray(aux["col"], dtype=bool)
            derr[:start_round] = np.asarray(aux["derr"], dtype=np.float64)
            # replay past boundaries' chaos against the world (no
            # controller calls: its state came from the aux ledger)
            lo_replay = 0
            while lo_replay < start_round:
                apply_boundary_chaos(lo_replay)
                lo_replay = min(lo_replay + chunk, R)
            # rows of finished chunks REHYDRATE from the journal, bitwise,
            # not recomputed
            if journal_path:
                journaled = _load_journal_rows(journal_path)
                rows = [journaled[r] for r in sorted(journaled) if r < start_round]
            elif "rows" in aux:
                rows = list(aux["rows"])

    pieces = []  # per-chunk params_history trees, on the run's device
    epochs: list = []
    arm_decisions: list = []
    last_res = None
    bandit = None
    bandit_epoch = -1
    arms_used: list = []
    train_wall = 0.0

    lo = start_round
    while lo < R:
        # chaos site "elastic": a kill here is a preemption at a chunk
        # boundary; the resumed run restores the ledger and replays
        chaos_lib.maybe_fire("elastic")
        for w in apply_boundary_chaos(lo):
            mem.request_join(w, round=lo)
        for w in default_join_offers(revives, mem.active, lo):
            mem.request_join(w, round=lo)
        change = mem.commit(lo)
        if change is not None:
            if change.dead:
                _emit(logger, "membership", round=lo, action="death",
                      workers=list(change.dead), n_workers=change.n_workers_after)
            if change.joined:
                _emit(logger, "membership", round=lo, action="join",
                      workers=list(change.joined), n_workers=change.n_workers_after)
            _emit(logger, "membership", round=lo, action="relayout",
                  workers=list(mem.active), n_workers=change.n_workers_after,
                  epoch=mem.epoch, n_workers_before=change.n_workers_before)

        hi = min(lo + chunk, R)
        active = list(mem.active)
        Wp = len(active)
        # epoch config: registry-validated survivor config (n_stragglers
        # shrunk where the scheme's divisibility demands it), the resolved
        # lr schedule continuous through every re-layout
        cfg_epoch = auto_survivor_config(cfg, Wp, survivor_overrides)
        if not epochs or epochs[-1]["workers"] != tuple(active):
            epochs.append({
                "start_round": lo,
                "epoch": mem.epoch,
                "workers": tuple(active),
                "n_workers": Wp,
                "n_stragglers": cfg_epoch.n_stragglers,
            })

        if adapt_arms is not None and bandit_epoch != mem.epoch:
            # arms re-seed against the new layout-stack signature: a fresh,
            # deterministically re-seeded bandit per epoch
            arms_used = _filter_arms(cfg_epoch, adapt_arms)
            bandit = AdaptiveController(
                arms_used,
                ControllerConfig(chunk_rounds=chunk, seed=ecfg.seed + mem.epoch,
                                 reward_mode="time_error"),
            )
            if bandit_state is not None:
                bandit.load_state_dict(bandit_state)
                bandit_state = None
            bandit_epoch = mem.epoch

        arm = None
        arm_idx = None
        cfg_chunk = dataclasses.replace(cfg_epoch, rounds=hi, lr_schedule=lr_full[:hi])
        if bandit is not None:
            arm_idx, _reason = bandit.choose()
            arm = arms_used[arm_idx]
            arm_decisions.append({**bandit.decisions[-1], "round": lo, "epoch": mem.epoch})
            cfg_chunk = dataclasses.replace(cfg_chunk, **arm.overrides())

        layout = trainer.build_layout(cfg_chunk)
        arr_e = base_arr[:hi][:, active].copy()
        arr_e[~avail[:hi][:, active]] = failures.DEAD
        schedule, _report = failures.plan_run(
            cfg_chunk.scheme, layout, arr_e,
            num_collect=cfg_chunk.num_collect,
            timeout=ecfg.timeout,
            on_infeasible="failover",
            deadline=cfg_chunk.deadline,
            decode=cfg_chunk.decode,
        )
        res = trainer.train(
            cfg_chunk, dataset, device=dev, arrivals=arr_e, schedule=schedule,
            init_params=init_params if state is None else None,
            initial_state=state, initial_round=lo if state is not None else 0,
            mesh=mesh,
        )
        state = res.final_state
        last_res = res
        train_wall += res.wall_time
        n_train_min = res.n_train if n_train_min is None else min(n_train_min, res.n_train)
        pieces.append(res.params_history)
        timeset[lo:hi] = res.timeset[lo:hi]
        wt[lo:hi, active] = res.worker_times[lo:hi]
        col[lo:hi, active] = res.collected[lo:hi]
        derr[lo:hi] = res.decode_error[lo:hi]

        # the master's per-round listening window: the failover timeout,
        # capped by the deadline when the chunk ran a deadline rule; rounds
        # whose clock ran the window out are the evidential ones
        window = ecfg.timeout
        if cfg_chunk.deadline is not None and schemes.get(cfg_chunk.scheme).needs_deadline:
            window = min(window, float(cfg_chunk.deadline))
        obs = mem.observe_chunk(
            lo, res.worker_times[lo:hi], sim_time=res.timeset[lo:hi], window=window,
        )
        if obs.collapse:
            _emit(logger, "membership", round=lo, action="probe",
                  n_workers=Wp, arrival_mean=obs.arrival_mean)
        if bandit is not None:
            raw = wt[lo:hi, active]
            arrived = raw[raw >= 0.0]
            stats = ChunkStats(
                n_rounds=hi - lo,
                sim_time=float(res.timeset[lo:hi].sum()),
                decode_error_mean=float(res.decode_error[lo:hi].mean()),
                arrival_mean=float(arrived.mean()) if arrived.size else None,
                arrival_p90=float(np.quantile(arrived, 0.9)) if arrived.size else None,
            )
            bandit.observe(arm_idx, stats)

        row = dict(
            round=lo,
            action="chunk",
            n_rounds=hi - lo,
            n_workers=Wp,
            workers=list(active),
            epoch=mem.epoch,
            sim_time=float(res.timeset[lo:hi].sum()),
            decode_error_mean=float(res.decode_error[lo:hi].mean()),
            params_digest=_digest_tree(state.params),
            arm=arm.label if arm is not None else None,
            n_stragglers=cfg_chunk.n_stragglers,
        )
        _emit(logger, "membership", **row)
        rows.append(dict(type="membership", **row))

        if checkpoint_dir and writer:
            aux = {
                "controller": mem.snapshot(),
                "bandit": bandit.state_dict() if bandit is not None else None,
                "n_train_min": n_train_min,
                "timeset": timeset[:hi].tolist(),
                "wt": wt[:hi].tolist(),
                "col": col[:hi].tolist(),
                "derr": derr[:hi].tolist(),
                "rows": rows,
            }
            ckpt_lib.save_with_aux(
                os.path.join(checkpoint_dir, f"round_{hi}"), state, hi, aux
            )
        lo = hi

    if logger is not None:
        logger.close()
    if last_res is None:
        raise ValueError(f"nothing to train: resume start {start_round} >= rounds {R}")

    merged = trainer.TrainResult(
        params_history=_cat_history(pieces),
        final_params=state.params,
        final_state=state,
        timeset=timeset,
        worker_times=wt,
        collected=col,
        sim_total_time=float(timeset.sum()),
        wall_time=train_wall,
        steps_per_sec=(R - start_round) / train_wall if train_wall > 0 else 0.0,
        n_train=n_train_min,
        start_round=start_round,
        config=cfg,
        layout=last_res.layout,
        decode_error=derr,
        lowering=last_res.lowering,
        cache_info=last_res.cache_info,
    )
    return ElasticResult(
        result=merged,
        decisions=list(mem.decisions),
        epochs=epochs,
        rows=rows,
        arm_decisions=arm_decisions,
        journal_path=journal_path,
        resumed_from=start_round,
    )
