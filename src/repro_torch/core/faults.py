"""Fault injection for the drivers: the paper's asynchrony, measured.

The paper claims Algorithm 1 "allows asynchronous individual updating":
nodes may update from stale broadcasts, sit out iterations, or lose
control messages, and the blocked sets and the accept rule keep the
trajectory convergent.  The drivers are bulk-synchronous, so this
module injects those faults into the fused driver's carry:

  bounded-staleness broadcasts   each node proposes from marginals up
                                 to `staleness_k` iterations old (a ring
                                 of the four marginal tensors the
                                 projection reads)
  partial participation          a fresh Bernoulli mask over the nodes
                                 each iteration gates which rows of φ
                                 update (Theorem 2's row masks, drawn
                                 per node)
  control-message dropout        a node's marginal broadcast is lost:
                                 the consumers reuse its last effective
                                 values (a `held` copy)
  transient value corruption     with probability `corrupt_p` an
                                 iteration poisons one random (task,
                                 node) data row of the candidate with
                                 NaN or Inf after its flows and cost
                                 were measured, so an accepting driver
                                 lands the poison in its carry (what
                                 `core.guards` catches)

Each injector is split into a draw and an apply.  `draw_faults` takes
every random number of one iteration from the fault generator, in a
fixed order and whatever the plan arms, so arming one injector never
shifts another's stream, and the fault stream never touches the
Theorem-2 generator.  `fault_step_begin` and `fault_step_end` apply the
draws with selects only, so the fused driver draws eagerly between the
replays of its CUDA graph and the graph applies them.  The JAX package
draws from `jax.random`, which torch cannot replay: a test feeds its
draws through `draw_faults` to hold a faulted trajectory against it.

A plan with no armed injector adds no operation (`fault_plan=None` is
the fault-free program); an armed but inert plan (participation 1.0,
dropout 0.0, corruption 0.0) selects the values the fault-free step
computes, bit for bit.

Under the task-sharded driver (`core.distributed`) every rank draws the
same faults (identically seeded generators), `fault_step_end(mesh=)`
draws the poisoned task over the whole task axis and only the rank that
holds it applies it, and `fault_state_specs` says which dimension of
each carry field is the task axis.  The port picks each kernel by its
tensors' device, so nothing here takes an `engine_impl`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .marginals import Marginals, compute_marginals
from .network import CECNetwork, Neighbors, Phi, PhiSparse


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Which injectors are armed, and how hard.  A None / 0 field leaves
    its injector out of the step; an armed but inert value (e.g.
    participation_p=1.0) runs its selects and changes nothing."""
    participation_p: Optional[float] = None  # P(node updates) an iteration
    staleness_k: int = 0                     # max marginal age (iterations)
    dropout_p: Optional[float] = None        # P(node's broadcast lost)
    corrupt_p: Optional[float] = None        # P(one row poisoned)
    corrupt_mode: str = "nan"                # "nan" | "inf"

    def __post_init__(self):
        if self.staleness_k < 0:
            raise ValueError("staleness_k must be >= 0")
        if self.corrupt_mode not in ("nan", "inf"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")

    @property
    def stale_marginals(self) -> bool:
        """The marginals are solved outside the propose (ring / hold)."""
        return self.staleness_k > 0 or self.dropout_p is not None


@dataclasses.dataclass(frozen=True)
class FaultDraws:
    """One iteration's draws, as the apply functions read them."""
    lag: torch.Tensor    # [V] int64 in [0, staleness_k]: broadcast age
    drop: torch.Tensor   # [V] bool: the node's broadcast is lost
    part: torch.Tensor   # [1, V] bool: the node updates
    fire: torch.Tensor   # [] bool: a row is poisoned
    u_s: torch.Tensor    # [] float32 in [0, 1): the poisoned task
    u_v: torch.Tensor    # [] float32 in [0, 1): the poisoned node


@dataclasses.dataclass(frozen=True)
class FaultState:
    """The fault carry: the fault generator, the staleness ring and the
    dropout hold (each the four marginal tensors the projection reads,
    (rho_data, rho_result, delta_data, delta_result), as [k+1, ...]
    stacks / last effective copies; None where the injector is unarmed)
    and the number of corruptions fired (an int32 device scalar)."""
    gen: torch.Generator
    ring: Optional[Tuple[torch.Tensor, ...]] = None
    held: Optional[Tuple[torch.Tensor, ...]] = None
    n_corrupt: Optional[torch.Tensor] = None


_MG_FIELDS = ("rho_data", "rho_result", "delta_data", "delta_result")


def _mg_tuple(mg: Marginals) -> tuple:
    return tuple(getattr(mg, f) for f in _MG_FIELDS)


def init_fault_state(net: CECNetwork, phi, fl, plan: FaultPlan,
                     rng: Optional[torch.Generator] = None,
                     method: str = "sparse",
                     nbrs: Optional[Neighbors] = None,
                     buckets=None) -> FaultState:
    """The fault state of iterate `phi` with flows `fl`: the ring and the
    hold start filled with φ's own marginals (age 0), so the first
    step's lag selects are defined; `rng` (a torch.Generator on the
    network's device) defaults to seed 0.  Under method="sparse" the
    carried F lies on the slots (`slot_F`), as in the step."""
    if rng is None:
        rng = torch.Generator(device=net.device).manual_seed(0)
    elif rng.device.type != net.device.type:
        raise ValueError(f"the fault generator lies on {rng.device}, the "
                         f"network on {net.device}")
    ring = held = None
    if plan.stale_marginals:
        vals = _mg_tuple(compute_marginals(
            net, phi, fl, method, nbrs=nbrs, slot_F=(method == "sparse"),
            buckets=buckets))
        if plan.staleness_k > 0:
            R = plan.staleness_k + 1
            ring = tuple(torch.stack([x] * R) for x in vals)
        if plan.dropout_p is not None:
            held = tuple(x.clone() for x in vals)
    return FaultState(gen=rng, ring=ring, held=held,
                      n_corrupt=torch.zeros((), dtype=torch.int32,
                                            device=net.device))


def fault_state_specs(plan: FaultPlan, axis: str = "tasks") -> FaultState:
    """How a FaultState lies over the task-sharded ranks, field by field:
    the dimension that is the task axis, None where the field is
    replicated (the generator and the count).  The ring stacks shard on
    dimension 1 (behind the age axis), the held copies on dimension 0,
    as the reference's PartitionSpecs over `axis` say; the structure
    matches `init_fault_state`'s for the same plan."""
    ring = (tuple(1 for _ in _MG_FIELDS) if plan.staleness_k > 0
            else None)
    held = (tuple(0 for _ in _MG_FIELDS) if plan.dropout_p is not None
            else None)
    return FaultState(gen=None, ring=ring, held=held, n_corrupt=None)


def draw_faults(gen: torch.Generator, plan: FaultPlan, S: int,
                V: int) -> FaultDraws:
    """Every draw of one iteration, from one `torch.rand` of 3·V + 3
    uniforms in a fixed order (participation, lag, dropout, fire, task,
    node), whatever the plan arms.  A Bernoulli(p) draw is u < p, as
    `jax.random.bernoulli`; an unarmed injector's draw is inert."""
    u = torch.rand(3 * V + 3, generator=gen, device=gen.device)
    k = plan.staleness_k
    p_part = 1.0 if plan.participation_p is None else plan.participation_p
    return FaultDraws(
        lag=torch.clamp_max((u[V:2 * V] * (k + 1)).to(torch.int64), k),
        drop=u[2 * V:3 * V] < (plan.dropout_p or 0.0),
        part=(u[:V] < p_part)[None],
        fire=u[3 * V] < (plan.corrupt_p or 0.0),
        u_s=u[3 * V + 1], u_v=u[3 * V + 2])


def draw_buffers(V: int, device) -> FaultDraws:
    """Inert draws, the buffers the fused driver copies each iteration's
    draws into."""
    return FaultDraws(
        lag=torch.zeros(V, dtype=torch.int64, device=device),
        drop=torch.zeros(V, dtype=torch.bool, device=device),
        part=torch.ones((1, V), dtype=torch.bool, device=device),
        fire=torch.zeros((), dtype=torch.bool, device=device),
        u_s=torch.zeros((), dtype=torch.float32, device=device),
        u_v=torch.zeros((), dtype=torch.float32, device=device))


# ------------------------------------------------------------- injectors
def fault_step_begin(net: CECNetwork, phi, fl, fs: FaultState,
                     plan: FaultPlan, draws: FaultDraws,
                     method: str = "sparse",
                     nbrs: Optional[Neighbors] = None, buckets=None):
    """The injectors before the propose: staleness, dropout,
    participation, applied from `draws`.

    Returns (mg, pmask, fs_mid): the marginals the propose must read
    (None: it solves them itself, staleness and dropout unarmed), the
    [1, V] bool participation mask (None: unarmed), and the state with
    its ring and hold updated (the generator is not advanced here)."""
    V = net.V
    mg = None
    ring_new, held_new = fs.ring, fs.held
    if plan.stale_marginals:
        fresh = compute_marginals(net, phi, fl, method, nbrs=nbrs,
                                  slot_F=(method == "sparse"),
                                  buckets=buckets)
        eff = _mg_tuple(fresh)
        if plan.staleness_k > 0:
            # push front: slot 0 is this iteration's broadcast, slot l is
            # l iterations old
            ring_new = tuple(torch.cat([f[None], r[:-1]])
                             for f, r in zip(eff, fs.ring))

            def at_lag(ring):
                out = ring[0]
                for age in range(1, plan.staleness_k + 1):
                    m = (draws.lag == age).reshape(
                        (1, V) + (1,) * (out.dim() - 2))
                    out = torch.where(m, ring[age], out)
                return out

            eff = tuple(at_lag(r) for r in ring_new)
        if plan.dropout_p is not None:
            def held_or(cur, held):
                m = draws.drop.reshape((1, V) + (1,) * (cur.dim() - 2))
                return torch.where(m, held, cur)

            eff = tuple(held_or(c, h) for c, h in zip(eff, fs.held))
            held_new = eff   # dropped nodes keep re-broadcasting the hold
        # D' and C' ride along fresh: the projection and the blocked sets
        # read only the four broadcast tensors
        mg = Marginals(*eff, fresh.Dp, fresh.Cp)
    pmask = draws.part if plan.participation_p is not None else None
    return mg, pmask, dataclasses.replace(fs, ring=ring_new, held=held_new)


def fault_step_end(net: CECNetwork, phi_new, draws: FaultDraws,
                   plan: FaultPlan, fs_mid: FaultState,
                   nbrs: Optional[Neighbors] = None, mesh=None):
    """The injector after the measurement: transient value corruption.

    If the draw fires, poison the data row (the real out-edge slots and
    the local column; padding slots stay 0) of one uniformly drawn
    (task, node) of the candidate; dense, the row's adjacency columns
    and the local one.  Runs after the candidate's flows and cost, so
    the measured cost is the healthy candidate's.  Under `mesh` (a
    `distributed.TaskMesh`, φ this rank's shard of S_l tasks) the task
    index is drawn over the whole axis of S_l · ranks tasks and only the
    rank that holds it poisons its row; every rank counts the firing.
    Returns (phi_out, fs_new) with the corruptions counted."""
    if plan.corrupt_p is None:
        return phi_new, fs_mid
    dev = phi_new.data.device
    poison = float("nan") if plan.corrupt_mode == "nan" else float("inf")
    S, V = phi_new.data.shape[0], net.V
    if mesh is None:
        s_idx = torch.clamp_max((draws.u_s * S).to(torch.int32), S - 1)
    else:
        # the global index from the replicated draw; a rank that does not
        # hold it selects no row (an index outside [0, S))
        S_g = S * mesh.size
        s_idx = (torch.clamp_max((draws.u_s * S_g).to(torch.int32), S_g - 1)
                 - mesh.rank * S)
    v_idx = torch.clamp_max((draws.u_v * V).to(torch.int32), V - 1)
    sel = ((torch.arange(S, device=dev) == s_idx)[:, None]
           & (torch.arange(V, device=dev) == v_idx)[None, :]
           & draws.fire)                                      # [S, V]
    if isinstance(phi_new, PhiSparse):
        data = torch.where(sel[..., None] & nbrs.out_mask[None], poison,
                           phi_new.data)
        local = torch.where(sel[..., None], poison, phi_new.local)
        phi_out = PhiSparse(data, local, phi_new.result)
    else:
        colmask = torch.cat([net.adj, torch.ones((V, 1), dtype=torch.bool,
                                                 device=dev)], dim=1)
        data = torch.where(sel[..., None] & colmask[None], poison,
                           phi_new.data)
        phi_out = Phi(data, phi_new.result)
    n_corrupt = fs_mid.n_corrupt + draws.fire.to(torch.int32)
    return phi_out, dataclasses.replace(fs_mid, n_corrupt=n_corrupt)
