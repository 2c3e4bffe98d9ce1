"""Algorithm 1 and the paper's evaluation (PyTorch port)."""
from .costs import SAT, Cost, CostFamily, FAMILIES
from .marginals import BIG, Marginals, compute_marginals, phi_gradients
from .network import (DENSE_V_LIMIT, CECNetwork, EdgeBuckets,
                      Flows, FlowsCarry, NeighborBuckets, Neighbors, Phi,
                      PhiSparse, as_dense_phi, build_buckets,
                      build_neighbors, compute_flows, cost_of_carry,
                      cost_of_flows, clear_task_slot, flows_carry,
                      flows_carry_and_cost, gather_edges, is_loop_free,
                      link_cost_sparse, mask_inactive_slots, mask_slots,
                      next_pow2, offload_phi, pad_phi_sparse, pad_tasks,
                      phi_to_sparse, refeasibilize, refeasibilize_sparse,
                      refeasibilize_sparse_samegraph, resolve_device,
                      sanitize_phi_sparse, scatter_edges, seed_task_slot,
                      solve_downstream_sparse, sparse_to_phi, spt_phi,
                      spt_phi_sparse, spt_result_slots, support_matrices,
                      total_cost, uniform_phi)
from .scenarios import (TABLE_II, ScenarioSpec, churn_hub, churn_schedule,
                        enforce_feasibility, fail_node, hub_node,
                        make_scenario, taskchurn_scenario)
from .sgp import (SIGMA_DECAY, FusedStream, SGPConsts, RunState,
                  accept_step, blocked_sets, blocked_sets_sparse, gp_rows,
                  init_run_state, make_consts, project_rows, run, run_chunk,
                  run_opt_keys, sgp_step, validate_run_opts)
from .events import (AdmissionEvent, ChurnSchedule, ChurnState, DestRedraw,
                     LinkCut, LinkRestore, NodeFail, NodeRecover, RateScale,
                     RateSet, SourceRedraw, TaskArrive, TaskDepart,
                     TaskPool, event_kind, random_schedule)
from .replay import (EventRecord, ReplayEngine, check_feasible,
                     check_invariants, iters_or_budget, iters_to_target)
from .faults import (FaultPlan, FaultState, fault_state_specs,
                     init_fault_state)
from .guards import GuardConfig, GuardEvent, GuardState, init_guard_state
from .distributed import (DistributedRunState, NodePartition,
                          build_node_partition, init_distributed_state,
                          node_flows_carry_and_cost, run_distributed,
                          run_distributed_chunk, task_mesh, task_node_mesh)
from .fleet import (FleetCache, FleetState, fleet_cache_key,
                    init_fleet_state, run_fleet, run_fleet_chunk,
                    stack_fleet)
from .baselines import run_all, run_lcor, run_lpr, run_spoo
from .optimality import (flow_domain_optimum, marginals_vs_autodiff,
                         theorem1_residual)
from . import topologies

__all__ = [
    "SAT", "Cost", "CostFamily", "FAMILIES", "BIG", "Marginals",
    "compute_marginals", "phi_gradients", "DENSE_V_LIMIT",
    "CECNetwork", "EdgeBuckets", "Flows", "FlowsCarry", "NeighborBuckets",
    "Neighbors", "Phi", "PhiSparse", "as_dense_phi", "build_buckets",
    "build_neighbors", "compute_flows", "cost_of_carry", "cost_of_flows",
    "flows_carry", "flows_carry_and_cost", "gather_edges", "is_loop_free",
    "link_cost_sparse", "mask_slots", "offload_phi", "phi_to_sparse",
    "refeasibilize", "resolve_device", "scatter_edges",
    "solve_downstream_sparse", "sparse_to_phi", "spt_phi",
    "spt_phi_sparse", "spt_result_slots", "support_matrices", "total_cost",
    "uniform_phi", "TABLE_II", "ScenarioSpec", "churn_hub",
    "enforce_feasibility", "fail_node", "hub_node", "make_scenario",
    "SIGMA_DECAY", "FusedStream", "SGPConsts", "RunState", "accept_step",
    "blocked_sets", "blocked_sets_sparse", "gp_rows", "init_run_state",
    "make_consts", "project_rows", "run", "run_chunk", "run_opt_keys",
    "validate_run_opts", "sgp_step", "churn_schedule",
    "taskchurn_scenario", "clear_task_slot", "mask_inactive_slots",
    "next_pow2", "pad_phi_sparse", "pad_tasks", "refeasibilize_sparse",
    "refeasibilize_sparse_samegraph", "sanitize_phi_sparse",
    "seed_task_slot", "AdmissionEvent", "ChurnSchedule", "ChurnState",
    "DestRedraw", "LinkCut", "LinkRestore", "NodeFail", "NodeRecover",
    "RateScale", "RateSet", "SourceRedraw", "TaskArrive", "TaskDepart",
    "TaskPool", "event_kind", "random_schedule", "EventRecord",
    "ReplayEngine", "check_feasible", "check_invariants",
    "iters_or_budget", "iters_to_target", "run_all", "run_lcor", "run_lpr",
    "run_spoo", "FaultPlan", "FaultState", "fault_state_specs",
    "init_fault_state", "GuardConfig", "GuardEvent", "GuardState",
    "init_guard_state", "FleetCache", "FleetState", "fleet_cache_key",
    "init_fleet_state", "run_fleet", "run_fleet_chunk", "stack_fleet",
    "DistributedRunState", "NodePartition", "build_node_partition",
    "init_distributed_state", "node_flows_carry_and_cost",
    "run_distributed", "run_distributed_chunk", "task_mesh",
    "task_node_mesh",
    "flow_domain_optimum", "marginals_vs_autodiff", "theorem1_residual",
    "topologies",
]
