"""Churn events for the streaming replay engine (`core.replay`).

The vocabulary of the online mode: small frozen event dataclasses, a
`ChurnSchedule` pairing each event with the global SGP iteration it
fires at, the `TaskPool` of recycled task slots, and `ChurnState`, which
turns a pristine scenario plus the events applied so far into the
CURRENT `CECNetwork`.

Events never mutate a network in place: `ChurnState` keeps the pristine
base plus the churn facts (failed nodes, cut links, logical rates,
destinations; under a pool the whole task pattern) as numpy arrays and
derives the live network from them, so recovery events are exact
inverses (`scenarios.fail_node`'s semantics, made reversible).  All
draws are numpy's `RandomState`, in the JAX package's order, so the
port's schedules and admissions are the reference's.

Event kinds (what the replay engine does after applying one):

  "rate"      rates scaled, graph identical: existing zero rates stay
              zero, so φ stays feasible and the driver re-baselines.
  "topology"  adjacency changed: the iterate goes through
              `refeasibilize_sparse` onto the new graph's `Neighbors`.
  "routing"   graph identical, task structure moved (a source or
              destination re-draw, a `RateSet`): the iterate is
              repaired on the same graph, a moved destination's task
              rebuilt from the SPT.
  "task"      an arrival or departure on the `TaskPool` (same graph,
              per-slot repair); "grow" when an arrival grew the pool's
              capacity, which changes S.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .network import CECNetwork, next_pow2


# ------------------------------------------------------------------ events
@dataclasses.dataclass(frozen=True)
class RateScale:
    """Scale the exogenous input rates of one task (or all) by `factor`."""
    factor: float
    task: Optional[int] = None      # None = every task


@dataclasses.dataclass(frozen=True)
class SourceRedraw:
    """Move task `task`'s data sources to fresh nodes (seeded); the rate
    values are kept, permuted onto the new sources."""
    task: int
    seed: int


@dataclasses.dataclass(frozen=True)
class DestRedraw:
    """Move task `task`'s destination: to `node` when given, else to a
    seeded draw over the currently alive nodes at apply time."""
    task: int
    seed: int = 0
    node: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RateSet:
    """Set exogenous rates outright: one task's row [V] (`task` given) or
    the whole [S, V] matrix.  It may put rate where there was none, so
    its kind is "routing" (the iterate is repaired).  Rates on failed
    nodes stay masked until the node recovers."""
    r: object                       # [V] (task given) or [S, V] array-like
    task: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class NodeFail:
    """Fail a node: links removed, compute disabled, its inputs stop,
    tasks destined to it go dark (`scenarios.fail_node`)."""
    node: int


@dataclasses.dataclass(frozen=True)
class NodeRecover:
    """Undo a `NodeFail`: original links, capacity and rates return."""
    node: int


@dataclasses.dataclass(frozen=True)
class LinkCut:
    """Cut the link u -> v (and v -> u when `both`)."""
    u: int
    v: int
    both: bool = True


@dataclasses.dataclass(frozen=True)
class LinkRestore:
    """Undo a `LinkCut` (only restores links the base graph has)."""
    u: int
    v: int
    both: bool = True


@dataclasses.dataclass(frozen=True)
class TaskArrive:
    """A new task claims a recycled slot of the `TaskPool`; with the pool
    full, its policy rejects, queues or grows.  r: [V] rates; dest:
    destination node; a: result ratio; w: compute weight (scalar or
    [V]); task_type: compute-cost family index."""
    r: object
    dest: int
    a: float = 1.0
    w: object = 1.0
    task_type: int = 0


@dataclasses.dataclass(frozen=True)
class TaskDepart:
    """Task slot `task` leaves: its rates stop, its φ rows return to the
    inert-slot convention, and the slot goes back to the free list (under
    "queue" a deferred arrival takes it at once)."""
    task: int


_KIND = {RateScale: "rate", RateSet: "routing",
         SourceRedraw: "routing", DestRedraw: "routing",
         NodeFail: "topology", NodeRecover: "topology",
         LinkCut: "topology", LinkRestore: "topology",
         TaskArrive: "task", TaskDepart: "task"}


def event_kind(event) -> str:
    """"rate" | "topology" | "routing" | "task" (module docstring);
    `ChurnState.apply` reports "grow" for an arrival that grew the
    pool."""
    return _KIND[type(event)]


# ------------------------------------------------------ task pool/admission
@dataclasses.dataclass(frozen=True)
class AdmissionEvent:
    """One admission decision: the action, the slot (-1 for reject and
    queue), the policy and the occupancy after it; `it` is stamped by
    the replay engine when it drains the pool's log (-1 before)."""
    action: str                     # admit | reject | queue | grow | dequeue
    slot: int
    policy: str
    n_active: int
    S_cap: int
    it: int = -1


class TaskPool:
    """Recycled task slots over a padded task axis, so arrivals and
    departures keep every shape.

    The network's task axis is padded to `S_cap` (a power of two by
    default) and the boolean [S_cap] `active` says which slots hold live
    tasks.  Inactive slots follow the inert-slot convention (r row 0,
    a 0, w 1, φ all-local with empty result rows): their traffic, flows
    and cost are exactly zero, and the masked step keeps their φ rows
    bit for bit.

    Admission (`policy`): "reject" drops an arrival when no slot is free,
    "queue" defers it to the next departure, "grow" moves to the next
    rung `next_pow2(S_cap + 1)`, the one case that changes S (the fused
    driver captures a new graph there).  Each decision is logged as an
    `AdmissionEvent`.

    `active_for_engine` gives the drivers None while the pool was built
    full and never had an empty slot (the fixed-S pass-through, bit for
    bit the plain engine), and the mask from the first empty slot on
    (`ever_padded`), even when it is momentarily all-True.

    `active` is rebound copy-on-write, never written in place: the
    engine uploads it with `upload`, which aliases the numpy buffer on
    the CPU."""

    POLICIES = ("reject", "queue", "grow")

    def __init__(self, n_tasks: int, S_cap: Optional[int] = None,
                 policy: str = "reject"):
        if policy not in self.POLICIES:
            raise ValueError(f"policy={policy!r} not in {self.POLICIES}")
        n_tasks = int(n_tasks)
        S_cap = next_pow2(n_tasks) if S_cap is None else int(S_cap)
        if S_cap < n_tasks:
            raise ValueError(f"S_cap={S_cap} < n_tasks={n_tasks}")
        self.policy = policy
        self.S_cap = S_cap
        active = np.zeros(S_cap, dtype=bool)
        active[:n_tasks] = True
        self.active = active
        self.queue: list = []           # deferred TaskArrive events (FIFO)
        self.log: list = []             # AdmissionEvents not yet drained
        self.ever_padded = n_tasks < S_cap

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def free_slot(self) -> Optional[int]:
        """Lowest inactive slot, or None when the pool is full."""
        idx = np.nonzero(~self.active)[0]
        return int(idx[0]) if idx.size else None

    def would_grow(self, event) -> bool:
        """True iff admitting `event` now would grow the pool (the stream
        breaks its window there)."""
        return (isinstance(event, TaskArrive) and self.policy == "grow"
                and self.free_slot() is None)

    def clone(self) -> "TaskPool":
        c = TaskPool.__new__(TaskPool)
        c.policy = self.policy
        c.S_cap = self.S_cap
        c.active = self.active.copy()
        c.queue = list(self.queue)
        c.log = list(self.log)
        c.ever_padded = self.ever_padded
        return c

    def admit(self, event: TaskArrive) -> Tuple[str, int]:
        """Admit, defer or reject one arrival: (action, slot), slot -1
        when none was claimed."""
        slot = self.free_slot()
        if slot is not None:
            active = self.active.copy()
            active[slot] = True
            self.active = active
            self._log("admit", slot)
            return "admit", slot
        if self.policy == "reject":
            self._log("reject", -1)
            return "reject", -1
        if self.policy == "queue":
            self.queue.append(event)
            self._log("queue", -1)
            return "queue", -1
        # grow: the next rung (a pinned non-power-of-two S_cap too)
        new_cap = next_pow2(self.S_cap + 1)
        active = np.zeros(new_cap, dtype=bool)
        active[:self.S_cap] = self.active
        slot = self.S_cap
        active[slot] = True
        self.S_cap = new_cap
        self.active = active
        self.ever_padded = True
        self._log("grow", slot)
        return "grow", slot

    def release(self, slot: int) -> Tuple[str, int, Optional[TaskArrive]]:
        """Free `slot`; under "queue" the oldest deferred arrival takes it.
        Returns (action, slot, the dequeued event or None)."""
        slot = int(slot)
        if not (0 <= slot < self.S_cap) or not self.active[slot]:
            raise ValueError(f"TaskDepart of inactive slot {slot}")
        active = self.active.copy()
        active[slot] = False
        self.active = active
        self.ever_padded = True
        if self.policy == "queue" and self.queue:
            event = self.queue.pop(0)
            active = self.active.copy()
            active[slot] = True
            self.active = active
            self._log("dequeue", slot)
            return "dequeue", slot, event
        return "release", slot, None

    def active_for_engine(self) -> Optional[np.ndarray]:
        """The mask the drivers thread (None: the fixed-S pass-through)."""
        return self.active if self.ever_padded else None

    def drain_log(self) -> list:
        out, self.log = self.log, []
        return out

    def _log(self, action: str, slot: int) -> None:
        self.log.append(AdmissionEvent(
            action=action, slot=slot, policy=self.policy,
            n_active=self.n_active, S_cap=self.S_cap))


# ---------------------------------------------------------------- schedule
@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """((iteration, event), ...) sorted by the global SGP iteration each
    event fires at.  Ties are allowed: the earlier event's segment then
    has zero iterations."""
    events: Tuple[Tuple[int, object], ...]
    name: str = ""

    def __post_init__(self):
        its = [t for t, _ in self.events]
        if any(b < a for a, b in zip(its, its[1:])):
            raise ValueError(f"schedule {self.name!r} events must fire "
                             "at non-decreasing iterations")

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def horizon(self) -> int:
        """Iteration of the last event (0 for an empty schedule)."""
        return self.events[-1][0] if self.events else 0


# ------------------------------------------------------------- churn state
def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class ChurnState:
    """Pristine scenario + applied events -> the current network.

    Keeps the churn facts as numpy arrays and derives the live
    `CECNetwork` on demand, on the base network's device; `apply` returns
    the event's kind."""

    def __init__(self, base: CECNetwork, pool: Optional[TaskPool] = None):
        self.base = base
        self.failed: set = set()
        self.cut: set = set()                       # directed (u, v) pairs
        self.r = _host(base.r).copy()               # logical rates
        self.dest = _host(base.dest).copy()
        self.pool = pool
        if pool is not None:
            if int(base.dest.shape[0]) != pool.S_cap:
                raise ValueError(
                    f"network has S={int(base.dest.shape[0])} task slots "
                    f"but the pool's S_cap={pool.S_cap}; pad the network "
                    "with network.pad_tasks first")
            self.a = _host(base.a).copy()
            self.w = _host(base.w).copy()
            self.task_type = _host(base.task_type).copy()
        else:
            self.a = self.w = self.task_type = None
        # φ repairs of the LAST task event: (("seed"|"clear", slot), ...)
        self.last_task_repairs: Tuple[Tuple[str, int], ...] = ()
        self._base_host = None          # (adj, compute params) on the host

    def clone(self) -> "ChurnState":
        """An independent copy sharing the (immutable) base network."""
        c = ChurnState.__new__(ChurnState)
        c.base = self.base
        c.failed = set(self.failed)
        c.cut = set(self.cut)
        c.r = self.r.copy()
        c.dest = self.dest.copy()
        c.pool = self.pool.clone() if self.pool is not None else None
        c.a = self.a.copy() if self.a is not None else None
        c.w = self.w.copy() if self.w is not None else None
        c.task_type = (self.task_type.copy()
                       if self.task_type is not None else None)
        c.last_task_repairs = self.last_task_repairs
        c._base_host = self._base_host
        return c

    # -------------------------------------------------------------- events
    def apply(self, event) -> str:
        """Fold one event in; returns its kind.

        The churn facts are rebound copy-on-write, never written in
        place: `network()` hands them to `torch.as_tensor`, which
        aliases a numpy buffer on the CPU, and a fused stream still has
        work queued on the previous network.  Task events record the
        per-slot φ repairs in `last_task_repairs`; an arrival that grew
        the pool returns "grow"."""
        self.last_task_repairs = ()
        if isinstance(event, TaskArrive):
            if self.pool is None:
                raise ValueError("TaskArrive/TaskDepart need a "
                                 "ChurnState(pool=TaskPool(...))")
            action, slot = self.pool.admit(event)
            if action == "grow":
                self._grow_to(self.pool.S_cap)
            if slot >= 0:
                self._write_task(slot, event)
                self.last_task_repairs = (("seed", slot),)
            return "grow" if action == "grow" else "task"
        if isinstance(event, TaskDepart):
            if self.pool is None:
                raise ValueError("TaskArrive/TaskDepart need a "
                                 "ChurnState(pool=TaskPool(...))")
            action, slot, dequeued = self.pool.release(int(event.task))
            self._clear_task(slot)
            if dequeued is not None:
                self._write_task(slot, dequeued)
                self.last_task_repairs = (("seed", slot),)
            else:
                self.last_task_repairs = (("clear", slot),)
            return "task"
        if isinstance(event, RateScale):
            if event.task is None:
                self.r = self.r * event.factor
            else:
                r = self.r.copy()
                r[event.task] *= event.factor
                self.r = r
        elif isinstance(event, RateSet):
            new_r = np.asarray(event.r, dtype=self.r.dtype)
            if event.task is None:
                if new_r.shape != self.r.shape:
                    raise ValueError(
                        f"RateSet matrix shape {new_r.shape} != r shape "
                        f"{self.r.shape}")
                self.r = new_r.copy()
            else:
                if new_r.shape != self.r[event.task].shape:
                    raise ValueError(
                        f"RateSet row shape {new_r.shape} != per-task "
                        f"shape {self.r[event.task].shape}")
                r = self.r.copy()
                r[event.task] = new_r
                self.r = r
        elif isinstance(event, SourceRedraw):
            rng = np.random.RandomState(event.seed)
            row = self.r[event.task].copy()
            vals = row[row > 0.0]
            alive = np.setdiff1d(np.arange(row.shape[0]), self._failed())
            if vals.size and alive.size >= vals.size:
                src = rng.choice(alive, size=vals.size, replace=False)
                row[:] = 0.0
                row[src] = rng.permutation(vals)
                r = self.r.copy()
                r[event.task] = row
                self.r = r
        elif isinstance(event, DestRedraw):
            new_node = None
            if event.node is not None and event.node not in self.failed:
                new_node = event.node
            else:
                rng = np.random.RandomState(event.seed)
                cand = np.setdiff1d(np.arange(self.r.shape[1]),
                                    self._failed())
                cand = cand[cand != self.dest[event.task]]
                if cand.size:
                    new_node = rng.choice(cand)
            if new_node is not None:
                dest = self.dest.copy()
                dest[event.task] = new_node
                self.dest = dest
        elif isinstance(event, NodeFail):
            self.failed.add(int(event.node))
        elif isinstance(event, NodeRecover):
            self.failed.discard(int(event.node))
        elif isinstance(event, LinkCut):
            self.cut.add((int(event.u), int(event.v)))
            if event.both:
                self.cut.add((int(event.v), int(event.u)))
        elif isinstance(event, LinkRestore):
            self.cut.discard((int(event.u), int(event.v)))
            if event.both:
                self.cut.discard((int(event.v), int(event.u)))
        else:
            raise TypeError(f"unknown churn event {event!r}")
        return event_kind(event)

    def _failed(self) -> np.ndarray:
        return np.fromiter(self.failed, int, len(self.failed))

    # ---------------------------------------------------------- task slots
    def _write_task(self, slot: int, ev: TaskArrive) -> None:
        """Write an admitted arrival's task pattern into `slot`."""
        V = self.r.shape[1]
        row = np.zeros(V, dtype=self.r.dtype)
        row[:] = np.asarray(ev.r, dtype=self.r.dtype)
        r = self.r.copy()
        r[slot] = row
        self.r = r
        dest = self.dest.copy()
        dest[slot] = int(ev.dest)
        self.dest = dest
        a = self.a.copy()
        a[slot] = float(ev.a)
        self.a = a
        w = self.w.copy()
        w[slot] = np.asarray(ev.w, dtype=self.w.dtype)   # scalar broadcasts
        self.w = w
        tt = self.task_type.copy()
        tt[slot] = int(ev.task_type)
        self.task_type = tt

    def _clear_task(self, slot: int) -> None:
        """`slot` back to the inert-slot convention (zero rate and result
        ratio, unit weight; dest and task_type stay, inert, which keeps
        the engine's SPT memo key stable)."""
        r = self.r.copy()
        r[slot] = 0.0
        self.r = r
        a = self.a.copy()
        a[slot] = 0.0
        self.a = a
        w = self.w.copy()
        w[slot] = 1.0
        self.w = w

    def _grow_to(self, S_cap: int) -> None:
        """Pad every task-axis fact to `S_cap` rows of inert slots."""
        S, V = self.r.shape
        r = np.zeros((S_cap, V), dtype=self.r.dtype)
        r[:S] = self.r
        self.r = r
        dest = np.zeros(S_cap, dtype=self.dest.dtype)
        dest[:S] = self.dest
        self.dest = dest
        a = np.zeros(S_cap, dtype=self.a.dtype)
        a[:S] = self.a
        self.a = a
        w = np.ones((S_cap,) + self.w.shape[1:], dtype=self.w.dtype)
        w[:S] = self.w
        self.w = w
        tt = np.zeros(S_cap, dtype=self.task_type.dtype)
        tt[:S] = self.task_type
        self.task_type = tt

    # ------------------------------------------------------------- network
    def network(self) -> CECNetwork:
        """The CURRENT network, on the base network's device.

        Failures apply `scenarios.fail_node`'s semantics (`fail_arrays`,
        its host core) in sorted node order, cut links are overlaid, and
        everything derives from the pristine base, so recovery is exact.
        The host facts go up without waiting on the device's queue
        (`upload`), so a fused stream keeps running while the next event
        is prepared."""
        from .scenarios import fail_arrays
        base = self.base
        dev = base.device
        r = self.r
        repl = {"dest": upload(self.dest, dev)}
        if self.pool is not None:
            repl.update(a=upload(self.a, dev), w=upload(self.w, dev),
                        task_type=upload(self.task_type, dev))
        if self.failed or self.cut:
            if self._base_host is None:
                self._base_host = (_host(base.adj),
                                   _host(base.comp_cost.params))
            adj, comp = self._base_host
            family = base.comp_cost.family
            for node in sorted(self.failed):
                adj, r, comp = fail_arrays(adj, r, self.dest, comp, family,
                                           node)
            if self.cut:
                adj = adj.copy()
                for (u, v) in self.cut:
                    adj[u, v] = False
            repl.update(adj=upload(adj, dev),
                        comp_cost=dataclasses.replace(
                            base.comp_cost, params=upload(comp, dev)))
        repl["r"] = upload(r, dev)
        return dataclasses.replace(base, **repl)


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`.  To the card through pinned
    memory without a wait on the device's queue; on the CPU it aliases
    the array (the churn facts are copy-on-write)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


# ------------------------------------------------------- random schedules
def _reaches(adj: np.ndarray, srcs, dest: int) -> bool:
    """True iff every node in `srcs` reaches `dest` on directed `adj`
    (BFS on the reversed graph from `dest`)."""
    want = {int(s) for s in srcs if int(s) != dest}
    if not want:
        return True
    seen = np.zeros(adj.shape[0], bool)
    seen[dest] = True
    frontier = [dest]
    while frontier:
        preds = np.nonzero(adj[:, frontier].any(axis=1) & ~seen)[0]
        seen[preds] = True
        frontier = list(preds)
    return all(seen[s] for s in want)


def _all_delivered(state: ChurnState) -> bool:
    """Every live exogenous source reaches its task's destination on the
    state's current network."""
    cur = state.network()
    adj, r, dest = (_host(cur.adj), _host(cur.r), _host(cur.dest))
    return all(_reaches(adj, np.nonzero(r[s] > 0.0)[0], int(dest[s]))
               for s in range(r.shape[0]))


def random_schedule(net: CECNetwork, n_events: int, seed: int = 0,
                    start: int = 1, gap: Tuple[int, int] = (1, 3),
                    max_failed: int = 2, max_cut: int = 2,
                    name: str = "",
                    pool: Optional[TaskPool] = None) -> ChurnSchedule:
    """A seeded, self-consistent random churn schedule, draw for draw the
    JAX package's.

    Recoveries and restores target only failed nodes and cut links;
    destinations (including ones a generated `DestRedraw` moves to) are
    never failed; at most `max_failed` nodes are down and `max_cut`
    links cut at once; and no event leaves a live source disconnected
    from its destination: each candidate is applied to a scratch
    `ChurnState` and checked on the network replay would derive, and a
    candidate that fails degrades to a `RateScale`.  With `pool` (a
    clone is consumed), arrivals and departures join the mix."""
    rng = np.random.RandomState(seed)
    base_adj = _host(net.adj)
    V = base_adj.shape[0]
    S = int(net.dest.shape[0])
    probe = ChurnState(net, pool=pool.clone() if pool is not None else None)
    events = []
    t = start

    def try_event(ev) -> bool:
        trial = probe.clone()
        trial.apply(ev)
        if not _all_delivered(trial):
            return False
        probe.apply(ev)               # commit (apply is deterministic)
        return True

    for _ in range(n_events):
        choices = ["rate", "rate", "source", "dest", "fail", "cut"]
        if probe.pool is not None:
            choices += ["arrive", "depart"]
        if probe.failed:
            choices += ["recover", "recover"]
        # probe.cut holds both directions of every both-way LinkCut
        canonical_cut = sorted({(min(u, v), max(u, v))
                                for (u, v) in probe.cut})
        if canonical_cut:
            choices.append("restore")
        kind = choices[rng.randint(len(choices))]
        ev = None
        # under a pool, re-draws target active slots only
        if probe.pool is not None:
            active_slots = np.nonzero(probe.pool.active)[0]
        else:
            active_slots = np.arange(S)
        if kind == "fail":
            protected = set(int(d) for d in probe.dest)
            cand = [i for i in range(V)
                    if i not in probe.failed and i not in protected]
            if len(probe.failed) < max_failed and cand:
                node = int(cand[rng.randint(len(cand))])
                if try_event(NodeFail(node)):
                    ev = NodeFail(node)
        elif kind == "recover":
            node = int(sorted(probe.failed)[rng.randint(len(probe.failed))])
            if try_event(NodeRecover(node)):
                ev = NodeRecover(node)
        elif kind == "cut":
            us, vs = np.nonzero(np.triu(base_adj | base_adj.T))
            ok = [(int(u), int(v)) for u, v in zip(us, vs)
                  if u not in probe.failed and v not in probe.failed
                  and (int(u), int(v)) not in probe.cut]
            if len(canonical_cut) < max_cut and ok:
                u, v = ok[rng.randint(len(ok))]
                if try_event(LinkCut(u, v)):
                    ev = LinkCut(u, v)
        elif kind == "restore":
            u, v = canonical_cut[rng.randint(len(canonical_cut))]
            if try_event(LinkRestore(u, v)):
                ev = LinkRestore(u, v)
        elif kind == "source" and active_slots.size:
            task = int(active_slots[rng.randint(active_slots.size)])
            cand = SourceRedraw(task, int(rng.randint(1 << 16)))
            if try_event(cand):
                ev = cand
        elif kind == "dest" and active_slots.size:
            task = int(active_slots[rng.randint(active_slots.size)])
            alive = [i for i in range(V) if i not in probe.failed
                     and i != int(probe.dest[task])]
            if alive:
                node = int(alive[rng.randint(len(alive))])
                if try_event(DestRedraw(task, node=node)):
                    ev = DestRedraw(task, node=node)
        elif kind == "arrive":
            alive = [i for i in range(V) if i not in probe.failed]
            n_src = min(1 + int(rng.randint(3)), max(len(alive) - 1, 1))
            src = rng.choice(alive, size=n_src, replace=False)
            row = np.zeros(V, dtype=float)
            row[src] = rng.uniform(0.4, 1.2, size=n_src)
            dest_node = int(alive[rng.randint(len(alive))])
            cand = TaskArrive(row, dest_node,
                              a=float(rng.uniform(0.2, 1.0)))
            if try_event(cand):
                ev = cand
        elif kind == "depart":
            act = np.nonzero(probe.pool.active)[0]
            if act.size > 1:       # never drain the system entirely here
                cand = TaskDepart(int(act[rng.randint(act.size)]))
                if try_event(cand):
                    ev = cand
        if ev is None:                    # "rate", or an infeasible pick
            ev = RateScale(float(rng.uniform(0.6, 1.6)),
                           task=None if rng.rand() < 0.5
                           else int(rng.randint(S)))
            probe.apply(ev)               # keep the probe in sync
        events.append((t, ev))
        t += int(rng.randint(gap[0], gap[1] + 1))
    return ChurnSchedule(tuple(events), name=name or f"random_{seed}")
