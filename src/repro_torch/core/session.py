"""Continuous-query sessions: registered queries over shared sampling passes.

The paper's system answers many concurrent continuous queries over one
geospatial stream, each with its own SLO.  A :class:`StreamSession`
amortizes the edge work across the whole registered workload:

  * ``register(query, slo=..., window=...)`` any number of declarative
    :class:`~.query.Query` specs, each with an optional pane-based
    :class:`~.windows.WindowSpec` (tumbling / sliding / hopping).
  * Registrations are partitioned incrementally into fusion groups:
    queries whose plans share a sampling signature
    (:func:`~.query.fusion_key`: method, mode, ROI) draw identical sampling
    decisions.  ``register`` joins (or opens) one group and ``unregister``
    leaves (or dissolves) one; no other group replans, and every admission
    decision lands in ``plan_log``.
  * Each ``step(generator, pane)`` runs one stratify + EdgeSOS pass per
    fusion group.  Due windows emit query by query, each through the
    finalize program cached for its signature and ring length.
  * Sliding and hopping windows merge pane accumulator states cloud-side
    (:func:`~.estimators.merge_accs_panes`) without re-reading tuples.
  * Per-query QoS runs through the vectorized controller
    (:func:`~.feedback.update_vector`) over the whole tenant population.
  * Per-query fraction refinement: a preagg group whose members' fractions
    differ (or a Bernoulli group whose ROIs differ) runs the refined pass
    (:func:`~.pipeline._fused_edge_program`): one shared stratify and
    uniform draw, thinned per member to its own fraction.
  * With ``PipelineConfig.uplink_codec`` set, each uplink frame (one per
    group, or one per member of a refined group) crosses the wire codec and
    the members finalize the decoded states; ``comm_bytes`` is measured.

Randomness.  A step reads one ``(N,)`` uniform vector, drawn with
``torch.rand`` from the step's generator (or given as ``uniforms=``), and
hands the same vector to every group's pass, as the reference package
hands its step key to every group unfolded.  The bootstrap's normals are
drawn after the uniforms, once per step and per normals layout
(:func:`~.query.normals_layout`), and every emit with that layout takes the
same draws.  So a one-query session step equals ``execute`` on the same
generator bit for bit.

Host syncs.  A step waits on the device where the reference package does:
at each codec frame (the uplink boundary, one copy of the frame's states
to the host) and once at the controller update (the new fractions, read
back for the next step's choice of program).

Programs (edge passes by plan, emits by finalize signature) are cached on
the :class:`~.pipeline.EdgeCloudPipeline`, so tenants that re-register
queries of shapes already seen build nothing (``pipe.compile_count``).
Checkpoint/restore and sharded sessions are not part of this package yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import codec as wirecodec
from . import estimators, feedback
from . import query as aqp
from .feedback import SLO, ControllerState
from .query import FusedPlan, Plan, Query, QueryResult, fuse, fusion_key
from .transfer import to_device
from .windows import WindowSpec


class _Pane(NamedTuple):
    """One pane's contribution to a registered query's window ring
    (``n_sampled`` is this member's own sample of the pane)."""

    stats: dict  # column -> {kind: state} (the query's columns and kinds)
    n_sampled: torch.Tensor
    n_valid: torch.Tensor
    n_overflow: torch.Tensor
    n_truncated: torch.Tensor
    n_dropped: int
    comm_bytes: int


@dataclasses.dataclass
class Registration:
    """Handle of one registered continuous query (returned by ``register``):
    its lowered plan, pane ring and its slice of the controller state
    (``fraction``/``re_ema``/``steps``, host mirrors).  ``slo=None`` means
    no QoS: the fraction stays fixed."""

    qid: int
    query: Query
    slo: SLO | None
    window: WindowSpec
    plan: Plan
    qos_key: str | None  # agg key driving QoS; None holds the fraction
    fraction: float
    re_ema: float = 0.0
    steps: int = 0
    panes_seen: int = 0
    ring: list = dataclasses.field(default_factory=list)
    # running count of tuples this query's own samples kept (on the device)
    downstream_tuples: int | torch.Tensor = 0
    # uplink bytes shipped for this query since its previous emit (host int)
    pending_comm: int = 0

    @property
    def qos_active(self) -> bool:
        return self.slo is not None and self.qos_key is not None

    @property
    def downstream_bytes(self) -> int:
        """Downstream volume this query's samples cost so far: kept tuples
        times the plan's per-tuple layout.  Reading it waits on the device."""
        return int(self.downstream_tuples) * aqp.downstream_tuple_bytes(self.plan)


class PlanDecision(NamedTuple):
    """One entry of the session's admission audit trail: ``outcome`` is
    ``new-group``, ``joined``, ``left`` or ``dissolved``; ``group_size`` the
    member count after the decision."""

    seq: int
    action: str  # "register" | "unregister"
    qid: int
    group_key: tuple  # fusion_key of the affected group
    outcome: str
    group_size: int


class _FusionGroup:
    """One fusion-signature cell of the partition, kept incrementally: its
    members (registration order), the lazily fused carrier plan, the
    pipeline programs it runs, and its codec streams ("shared" or a member
    qid -> codec), dropped on any membership change so a stateful (delta)
    stream re-opens with a keyframe."""

    __slots__ = ("key", "members", "_fused", "_pass_fn", "_refined_fn", "_codec")

    def __init__(self, key: tuple):
        self.key = key
        self.members: list[Registration] = []
        self._fused: FusedPlan | None = None
        self._pass_fn = None
        self._refined_fn = None
        self._codec: dict = {}

    def invalidate(self) -> None:
        self._fused = None
        self._pass_fn = None
        self._refined_fn = None
        self._codec = {}

    def fused_plan(self) -> FusedPlan:
        if self._fused is None:
            self._fused = fuse([r.plan for r in self.members])
        return self._fused


class SessionStep(NamedTuple):
    """Outcome of feeding one pane to the session.

    results: qid -> QueryResult for the queries whose window emitted this
      pane (a query with stride s emits every s panes).
    fractions: qid -> post-update controller fraction, every registration.
    comm_bytes: uplink bytes of this pane's passes (one frame per group, or
      per member of a refined group): the dense analytic model, or the
      measured encoded bytes with an uplink codec.  A host int.
    n_dropped: tuples shed before this pane reached the device.
    pane_index: 0-based index of the pane within the session.
    drop_causes: cause -> tuples of ``n_dropped`` (uncaused counts land in
      ``late``).
    """

    results: dict
    fractions: dict
    comm_bytes: int
    n_dropped: int
    pane_index: int
    drop_causes: dict = {}


class _Normals:
    """The bootstrap draws of one step (or serving read): drawn from the
    generator once per normals layout, on first use, and shared by every
    emit with that layout; or taken from ``given(plan, stats)``."""

    def __init__(self, table, generator, given=None):
        self.table = table
        self.generator = generator
        self.given = given
        self._drawn: dict[tuple, dict] = {}

    def __call__(self, plan: Plan, stats: dict) -> dict:
        if self.given is not None:
            return self.given(plan, stats)
        layout = aqp.normals_layout(plan, self.table, stats)
        draws = self._drawn.get(layout)
        if draws is None:
            draws = self._drawn[layout] = aqp.bootstrap_normals(plan, self.table, stats,
                                                                self.generator)
        return draws


class StreamSession:
    """Continuous-query engine over an :class:`~.pipeline.EdgeCloudPipeline`.

    Typical use::

        sess = StreamSession(pipe)
        speed = sess.register(Query(aggs=(AggSpec("mean", "value"),)),
                              slo=SLO(target_relative_error=0.05))
        occ = sess.register(Query(aggs=(AggSpec("mean", "occupancy"),)),
                            window=WindowSpec("sliding", size=4))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for step in sess.run(pane_windows(stream, pane_tuples=20_000), gen):
            if speed.qid in step.results:
                ...  # step.results[speed.qid].estimates["mean_value"]

    The session runs on its pipeline's device.  Emits go query by query;
    ``batched_finalize`` is accepted for the reference package's signature
    and changes nothing.
    """

    def __init__(self, pipeline, *, sharded: bool = False, initial_fraction: float = 0.8,
                 batched_finalize: bool = True):
        if sharded:
            raise NotImplementedError(
                "sharded sessions arrive with the sharded path of the port "
                "(ROADMAP §1 item 13)"
            )
        self.pipe = pipeline
        self.initial_fraction = float(initial_fraction)
        self.pane_index = 0
        self.total_comm_bytes = 0
        self.total_dropped = 0
        self.total_dropped_by_cause: dict = {}
        self.total_passes = 0  # edge passes run (one per fusion group per pane)
        self._regs: dict[int, Registration] = {}
        self._next_qid = 0
        self._fusion_groups: dict[tuple, _FusionGroup] = {}
        self._reg_group: dict[int, _FusionGroup] = {}
        self.plan_log: list[PlanDecision] = []
        # controller layout (qid -> row, stacked SLOs), rebuilt lazily after
        # membership changes
        self._rows: dict[int, int] = {}
        self._slo_stack: feedback.StackedSLO | None = None
        self._ctrl_dirty = True

    @property
    def device(self) -> torch.device:
        return self.pipe.device

    # -- registration --------------------------------------------------------

    def register(self, query: Query, *, slo: SLO | None = None, window: WindowSpec | None = None,
                 initial_fraction: float | None = None) -> Registration:
        """Register a continuous query; returns its handle.  It joins (or
        opens) one fusion group from the next ``step``; no other group
        replans.  The first error-bounded aggregate (sum/mean, and var or a
        quantile while its bootstrap is on) drives its controller."""
        window = window or WindowSpec()
        plan = self.pipe.plan(query)
        boot_on = query.bootstrap_replicates > 0

        def _drives(a) -> bool:
            if a.kind in ("sum", "mean"):
                return True
            return boot_on and (a.kind == "var" or aqp.quantile_of(a.kind) is not None)

        reg = Registration(
            qid=self._next_qid,
            query=query,
            slo=slo,
            window=window,
            plan=plan,
            qos_key=next((a.key for a in query.aggs if _drives(a)), None),
            fraction=float(self.initial_fraction if initial_fraction is None
                           else initial_fraction),
        )
        self._next_qid += 1
        self._regs[reg.qid] = reg
        gkey = fusion_key(plan)
        grp = self._fusion_groups.get(gkey)
        outcome = "joined" if grp is not None else "new-group"
        if grp is None:
            grp = self._fusion_groups[gkey] = _FusionGroup(gkey)
        grp.members.append(reg)
        grp.invalidate()
        self._reg_group[reg.qid] = grp
        self._log_decision("register", reg.qid, gkey, outcome, len(grp.members))
        self._ctrl_dirty = True
        return reg

    def unregister(self, reg: Registration) -> None:
        """Drop a registered query (its pane ring is discarded); its group
        dissolves when emptied, no other group replans."""
        if self._regs.pop(reg.qid, None) is None:
            return
        grp = self._reg_group.pop(reg.qid)
        grp.members.remove(reg)
        grp.invalidate()
        if grp.members:
            outcome = "left"
        else:
            del self._fusion_groups[grp.key]
            outcome = "dissolved"
        self._log_decision("unregister", reg.qid, grp.key, outcome, len(grp.members))
        self._ctrl_dirty = True

    def _log_decision(self, action: str, qid: int, gkey: tuple, outcome: str, size: int) -> None:
        self.plan_log.append(PlanDecision(seq=len(self.plan_log), action=action, qid=qid,
                                          group_key=gkey, outcome=outcome, group_size=size))

    @property
    def registrations(self) -> tuple[Registration, ...]:
        return tuple(self._regs.values())

    def controller_state(self, reg: Registration) -> ControllerState:
        """This registration's slice of the controller state."""
        dev = self.device
        return ControllerState(
            fraction=torch.tensor(reg.fraction, dtype=torch.float32, device=dev),
            re_ema=torch.tensor(reg.re_ema, dtype=torch.float32, device=dev),
            steps=torch.tensor(reg.steps, dtype=torch.int32, device=dev),
        )

    def _groups(self) -> list[list[Registration]]:
        """The fusion partition as member lists: registration order within
        groups, group-creation order across them."""
        return [list(g.members) for g in self._fusion_groups.values()]

    # -- uplink accounting ---------------------------------------------------

    def _analytic_comm(self, fused: FusedPlan, n_rows: int) -> int:
        """Uplink bytes of one shared pass, from the plan alone (the dense
        model ``_edge_program`` reports), so the step never reads it back."""
        plan = fused.shared
        if plan.query.mode == "raw":
            return aqp.raw_bytes(plan, self.pipe.config.raw_capacity or n_rows)
        return aqp.preagg_bytes(plan, self.pipe.table.num_slots)

    def _codec_ship(self, grp: _FusionGroup, slot, stats) -> tuple[dict, int]:
        """Ship one uplink stream's states through the configured codec:
        the decoded states the cloud consolidates and the frame's measured
        bytes.  ``slot`` names the stream within the group ("shared" for
        the union pass, the member qid for refined frames).  One host sync:
        the uplink boundary itself."""
        stream = grp._codec.get(slot)
        if stream is None:
            stream = grp._codec[slot] = self.pipe.codec_spec.for_stream()
        return wirecodec.roundtrip(stream, stats)

    # -- emits -----------------------------------------------------------------

    def _window_counters(self, reg: Registration) -> tuple:
        """This query's window counters summed over its pane ring (device
        adds; host ints for bytes and drops).  ``comm`` is the bytes newly
        shipped since its previous emit (``pending_comm``), so overlapping
        windows do not count a shared pane twice."""
        panes = reg.ring
        n_sampled, n_valid, n_overflow, n_truncated = panes[0][1:5]
        for p in panes[1:]:
            n_sampled = n_sampled + p.n_sampled
            n_valid = n_valid + p.n_valid
            n_overflow = n_overflow + p.n_overflow
            n_truncated = n_truncated + p.n_truncated
        dropped = sum(p.n_dropped for p in panes)
        return (n_sampled, n_valid, n_overflow, n_truncated, reg.pending_comm, dropped)

    def _window_stats(self, reg: Registration):
        """The ring's stats, stacked on a leading pane axis when the window
        spans several panes (one pane passes through, keeping the bits of
        ``execute``)."""
        panes = reg.ring
        if len(panes) == 1:
            return panes[0].stats
        return estimators.stack_trees([p.stats for p in panes])

    def _emit(self, reg: Registration, normals: _Normals) -> QueryResult:
        """Assemble this query's window from its ring and finalize it."""
        stats = self._window_stats(reg)
        fn = self.pipe.finalize_fn(reg.plan, len(reg.ring))
        estimates, stats = fn(stats, normals(reg.plan, reg.ring[0].stats))
        n_sampled, n_valid, n_overflow, n_truncated, comm, dropped = self._window_counters(reg)
        return QueryResult(estimates=estimates, stats=stats, n_sampled=n_sampled,
                           n_valid=n_valid, n_overflow=n_overflow, n_truncated=n_truncated,
                           comm_bytes=comm, n_dropped=dropped)

    def _emit_due(self, due: list, normals: _Normals, out: dict) -> list:
        """Emit every due registration into ``out``, query by query;
        returns the ``(registration, result)`` pairs for the controller
        update."""
        emitted = []
        for reg in due:
            res = out[reg.qid] = self._emit(reg, normals)
            emitted.append((reg, res))
        return emitted

    def emit_all(self, generator: torch.Generator | None = None, *,
                 normals=None) -> dict:
        """Finalize every registration's current window on demand, the
        pull-based serving read between panes: no pane, window or
        controller advances; registrations never stepped are absent.
        Bootstrap draws come from ``generator`` (once per layout) unless
        ``normals(plan, stats)`` gives them."""
        out: dict = {}
        due = [r for r in self._regs.values() if r.ring]
        self._emit_due(due, _Normals(self.pipe.table, generator, normals), out)
        return out

    # -- the continuous loop -------------------------------------------------

    @staticmethod
    def _refines(fused: FusedPlan, fractions: list[float]) -> bool:
        """Host-side choice of edge program for one group this pane: the
        shared pass for single members and same-fraction same-ROI groups,
        the refined pass for preagg groups whose fractions differ and for
        cross-ROI Bernoulli groups.  Raw-mode and Neyman groups always
        share."""
        if len(fused.members) < 2:
            return False
        if fused.cross_roi:
            return True
        if fused.mode != "preagg" or fused.shared.query.method == "neyman":
            return False
        return len(set(fractions)) > 1

    def step(self, generator: torch.Generator | None, pane, *, uniforms=None,
             normals=None) -> SessionStep:
        """Feed one pane through every fusion group and emit due windows.

        One ``(N,)`` uniform vector (``torch.rand`` on ``generator``, or
        ``uniforms``) serves every group's pass; the bootstrap draws follow
        from the same generator once per layout, or come from
        ``normals(plan, stats)``.  So a one-group session reproduces
        ``execute(query, generator, pane, fraction)`` exactly."""
        if not self._regs:
            raise ValueError("step() on a session with no registered queries")
        n_dropped = int(getattr(pane, "n_dropped", 0))
        drop_causes = dict(getattr(pane, "drop_causes", None) or {})
        uncaused = n_dropped - sum(drop_causes.values())
        if uncaused > 0:  # producers without causes: window-level sheds count as late
            drop_causes["late"] = drop_causes.get("late", 0) + uncaused
        groups = list(self._fusion_groups.values())
        columns = tuple(dict.fromkeys(c for g in groups for c in g.fused_plan().shared.columns))
        lat, lon, cols, valid = self.pipe._window_arrays(pane, columns)
        u = self.pipe._uniforms(generator, lat.shape[0], uniforms)
        codec_on = self.pipe.codec_spec is not None
        emitted: dict = {}
        due: list[Registration] = []
        comm_total = 0
        for grp in groups:
            members = grp.members
            fused = grp.fused_plan()
            fractions = [r.fraction for r in members]
            gcols = {c: cols[c] for c in fused.shared.columns}
            if self._refines(fused, fractions):
                if grp._refined_fn is None:
                    grp._refined_fn = self.pipe._refined_pass_fn(fused)
                outs, _ = grp._refined_fn(u, lat, lon, gcols, valid, fractions)
                zero = torch.zeros((), dtype=torch.int32, device=u.device)  # no raw buffer
                if codec_on:
                    # each member's thinned states are its own uplink stream
                    shipped = [self._codec_ship(grp, reg.qid, out[0])
                               for reg, out in zip(members, outs)]
                    comm = sum(nb for _st, nb in shipped)
                    per_member = [(st, ns, nv, no, zero, nb)
                                  for (st, nb), (_st, ns, nv, no) in zip(shipped, outs)]
                else:
                    comm = aqp.refined_preagg_bytes(fused, self.pipe.table.num_slots)
                    per_member = [(st, ns, nv, no, zero, comm) for st, ns, nv, no in outs]
            else:
                if grp._pass_fn is None:
                    grp._pass_fn = self.pipe._pass_fn(fused.shared)
                stats, n_sampled, n_valid, n_overflow, n_truncated, _ = grp._pass_fn(
                    u, lat, lon, gcols, valid, max(fractions)
                )
                if codec_on and fused.mode == "preagg":
                    # one union frame serves the group; members carve the
                    # decoded states, so they reflect what crossed the wire
                    stats, comm = self._codec_ship(grp, "shared", stats)
                else:
                    comm = self._analytic_comm(fused, lat.shape[0])
                per_member = []
                for reg in members:
                    kinds_map = reg.plan.column_kind_map
                    carved = {c: {k: stats[c][k] for k in kinds_map[c]} for c in reg.plan.columns}
                    per_member.append((carved, n_sampled, n_valid, n_overflow, n_truncated, comm))
            comm_total += comm
            self.total_passes += 1
            for reg, (stats_m, n_s, n_v, n_o, n_t, comm_m) in zip(members, per_member):
                reg.ring.append(_Pane(stats=stats_m, n_sampled=n_s, n_valid=n_v, n_overflow=n_o,
                                      n_truncated=n_t, n_dropped=n_dropped, comm_bytes=comm_m))
                del reg.ring[: -reg.window.size]
                reg.panes_seen += 1
                reg.pending_comm += comm_m
                reg.downstream_tuples = reg.downstream_tuples + n_s
                if reg.panes_seen % reg.window.stride == 0:
                    due.append(reg)
        results = self._emit_due(due, _Normals(self.pipe.table, generator, normals), emitted)
        for reg in due:  # emitted windows consumed their newly shipped bytes
            reg.pending_comm = 0
        self._update_controllers(results)
        self.pane_index += 1
        self.total_comm_bytes += comm_total
        self.total_dropped += n_dropped
        for cause, n in drop_causes.items():
            self.total_dropped_by_cause[cause] = self.total_dropped_by_cause.get(cause, 0) + n
        return SessionStep(
            results=emitted,
            fractions={r.qid: r.fraction for r in self._regs.values()},
            comm_bytes=comm_total,
            n_dropped=n_dropped,
            pane_index=self.pane_index - 1,
            drop_causes=drop_causes,
        )

    def run(self, panes, generator: torch.Generator | None = None) -> list[SessionStep]:
        """Step the panes in order, every step drawing from ``generator``
        (None: PyTorch's default generator)."""
        return [self.step(generator, pane) for pane in panes]

    def checkpoint(self, path=None, keep_last: int | None = None) -> dict:
        raise NotImplementedError(
            "session checkpoints arrive with the checkpoint slice of the port (ROADMAP §1 item 11)"
        )

    def restore(self, snapshot) -> "StreamSession":
        raise NotImplementedError(
            "session restore arrives with the checkpoint slice of the port (ROADMAP §1 item 11)"
        )

    # -- vectorized QoS ------------------------------------------------------

    def _controller_layout(self) -> tuple[dict, feedback.StackedSLO]:
        """(qid -> row) map and stacked SLOs of the current registrations,
        rebuilt only after membership changes."""
        if self._ctrl_dirty:
            regs = list(self._regs.values())
            self._rows = {r.qid: i for i, r in enumerate(regs)}
            self._slo_stack = feedback.stack_slos([r.slo or SLO() for r in regs], self.device)
            self._ctrl_dirty = False
        return self._rows, self._slo_stack

    @staticmethod
    def _worst_finite(rel: torch.Tensor) -> torch.Tensor:
        """Per row, the largest finite RE over the group axis (the last);
        inf where no group has one, which holds the fraction."""
        finite = torch.isfinite(rel)
        worst = torch.amax(torch.where(finite, rel, 0.0), dim=-1)
        return torch.where(torch.any(finite, dim=-1), worst, torch.inf)

    @classmethod
    def _observed_re(cls, reg: Registration, res: QueryResult) -> torch.Tensor:
        """The scalar RE driving this query's controller: its first
        error-bounded aggregate's; a grouped query reports its worst group
        with a finite RE."""
        rel = res.estimates[reg.qos_key].relative_error
        return cls._worst_finite(rel) if rel.dim() else rel

    def _update_controllers(self, results: list) -> None:
        """One vectorized controller step over all registrations; only the
        queries that emitted an error-bounded result this pane advance.
        The new fractions are read back once."""
        active_rows: list[int] = []
        observed_re, observed_n = [], []
        for reg, res in results:
            if not reg.qos_active:
                continue
            if not active_rows:
                rows, slo_stack = self._controller_layout()
            active_rows.append(rows[reg.qid])
            observed_re.append(self._observed_re(reg, res).to(torch.float32))
            observed_n.append(res.n_valid.to(torch.float32))
        if not active_rows:
            return
        dev = self.device
        regs = list(self._regs.values())
        state = feedback.stack_states(((r.fraction, r.re_ema, r.steps) for r in regs), dev)
        segments = [(active_rows, torch.stack(observed_re), torch.stack(observed_n))]
        re_obs, n_obs = feedback.scatter_observations(len(regs), segments, dev)
        active = [False] * len(regs)
        for i in active_rows:
            active[i] = True
        new = feedback.update_vector(state, re_obs, n_obs, slo_stack,
                                     to_device(active, torch.bool, dev))
        # the step's one controller readback: the next step chooses its
        # programs (_refines) from these host fractions
        frac, ema = torch.stack([new.fraction, new.re_ema]).cpu().tolist()
        for i, reg in enumerate(regs):
            if active[i]:
                reg.fraction = frac[i]
                reg.re_ema = ema[i]
                reg.steps += 1
