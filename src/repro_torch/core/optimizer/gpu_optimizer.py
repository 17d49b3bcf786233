"""SLO-driven heterogeneous GPU optimizer (paper §3.2.7, Figure 8).

Three components, matching the paper's architecture figure:

  * LoadMonitor  — turns gateway request logs into bucketed demand rates
  * GPUOptimizer — Mélange-inspired ILP: pick GPU counts per type that
                   minimize $/h subject to (a) every bucket's demand is
                   served, (b) only SLO-meeting (bucket, device)
                   assignments are allowed, (c) availability caps.
                   scipy MILP when available, greedy cover fallback.
  * External metric source — desired counts are exposed in the format
    the Pod Autoscaler consumes (one desired-replicas value per
    deployment), closing the paper's optimizer -> autoscaler loop.

Plus the role planner for P/D disaggregation: :func:`split_roles`
proposes the initial prefill:decode engine ratio from the roofline
profile and the SLO targets (prefill engine-seconds vs decode
engine-seconds per offered request); the RolePoolManager's
attainment-driven rebalancer then adapts that ratio live.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.optimizer.profiles import (DEVICES, PerfModel,
                                           ProfileTable, WorkloadBucket)


@dataclass
class DemandBucket:
    bucket: WorkloadBucket
    rps: float


class LoadMonitor:
    """Aggregates gateway logs into representative workload buckets."""

    def __init__(self, in_edges: Sequence[int] = (200, 1000, 4000),
                 out_edges: Sequence[int] = (100, 500)):
        self.in_edges = list(in_edges)
        self.out_edges = list(out_edges)

    def _rep(self, idx: int, edges: List[int]) -> int:
        """Representative length for a bucket index."""
        lo = 0 if idx == 0 else edges[idx - 1]
        hi = edges[idx] if idx < len(edges) else lo * 2 or 8000
        return max((lo + hi) // 2, 16)

    def demand(self, request_log, window_s: float = 600.0,
               now: Optional[float] = None) -> List[DemandBucket]:
        if not request_log:
            return []
        now = request_log[-1][0] if now is None else now
        rows = [r for r in request_log if r[0] >= now - window_s]
        span = max(window_s, 1e-9)
        counts: Dict[Tuple[int, int], int] = {}
        for _, ilen, olen, _, _ in rows:
            bi = sum(ilen >= e for e in self.in_edges)
            bo = sum(olen >= e for e in self.out_edges)
            counts[(bi, bo)] = counts.get((bi, bo), 0) + 1
        out = []
        for (bi, bo), c in sorted(counts.items()):
            b = WorkloadBucket(self._rep(bi, self.in_edges),
                               self._rep(bo, self.out_edges))
            out.append(DemandBucket(b, c / span))
        return out


@dataclass
class Allocation:
    counts: Dict[str, int]
    cost_per_hour: float
    assignment: Dict[Tuple[Tuple[int, int], str], float]
    feasible: bool = True
    note: str = ""


class GPUOptimizer:
    def __init__(self, table: ProfileTable,
                 device_types: Sequence[str] = ("a10", "l20", "v100"),
                 availability: Optional[Dict[str, int]] = None,
                 headroom: float = 1.2):
        self.table = table
        self.device_types = list(device_types)
        self.availability = availability or {}
        self.headroom = headroom

    # ------------------------------------------------------------- solve
    def optimize(self, demand: List[DemandBucket]) -> Allocation:
        demand = [d for d in demand if d.rps > 0]
        if not demand:
            return Allocation({g: 0 for g in self.device_types}, 0.0, {})
        caps = {(i, gi): self.table.capacity(name, d.bucket)
                for i, d in enumerate(demand)
                for gi, name in enumerate(self.device_types)}
        try:
            return self._solve_milp(demand, caps)
        except Exception as e:  # scipy missing / infeasible numerical
            alloc = self._solve_greedy(demand, caps)
            alloc.note = f"greedy fallback ({type(e).__name__})"
            return alloc

    def _solve_milp(self, demand, caps) -> Allocation:
        import numpy as np
        from scipy.optimize import LinearConstraint, milp
        from scipy.optimize import Bounds

        nb, ng = len(demand), len(self.device_types)
        # variables: x[i,g] rps of bucket i on type g (continuous),
        #            n[g] device count (integer)
        nx = nb * ng

        def xi(i, g):
            return i * ng + g

        c = np.zeros(nx + ng)
        for g, name in enumerate(self.device_types):
            c[nx + g] = DEVICES[name].cost_per_hour
        A_rows, lbs, ubs = [], [], []
        # demand served: sum_g x[i,g] == demand_i * headroom
        for i, d in enumerate(demand):
            row = np.zeros(nx + ng)
            for g in range(ng):
                row[xi(i, g)] = 1.0
            A_rows.append(row)
            lbs.append(d.rps * self.headroom)
            ubs.append(d.rps * self.headroom)
        # capacity: sum_i x[i,g]/cap[i,g] <= n[g]
        for g in range(ng):
            row = np.zeros(nx + ng)
            for i in range(nb):
                cap = caps[(i, g)]
                row[xi(i, g)] = (1.0 / cap) if cap > 0 else 1e9
            row[nx + g] = -1.0
            A_rows.append(row)
            lbs.append(-np.inf)
            ubs.append(0.0)
        ub_x = np.full(nx + ng, np.inf)
        for g, name in enumerate(self.device_types):
            if name in self.availability:
                ub_x[nx + g] = self.availability[name]
        integrality = np.concatenate([np.zeros(nx), np.ones(ng)])
        res = milp(c=c,
                   constraints=LinearConstraint(np.array(A_rows),
                                                np.array(lbs),
                                                np.array(ubs)),
                   integrality=integrality,
                   bounds=Bounds(np.zeros(nx + ng), ub_x))
        if not res.success:
            raise RuntimeError(f"milp failed: {res.message}")
        counts = {name: int(round(res.x[nx + g]))
                  for g, name in enumerate(self.device_types)}
        assignment = {}
        for i, d in enumerate(demand):
            for g, name in enumerate(self.device_types):
                v = float(res.x[xi(i, g)])
                if v > 1e-9:
                    assignment[(d.bucket.key, name)] = v
        cost = sum(counts[n] * DEVICES[n].cost_per_hour for n in counts)
        return Allocation(counts, cost, assignment)

    def _solve_greedy(self, demand, caps) -> Allocation:
        """Cheapest-per-request device per bucket, then pack counts."""
        load_per_dev: Dict[str, float] = {g: 0.0 for g in self.device_types}
        assignment = {}
        for i, d in enumerate(demand):
            best, best_cpr = None, float("inf")
            for g, name in enumerate(self.device_types):
                cap = caps.get((i, g), 0)
                if cap <= 0:
                    continue
                cpr = DEVICES[name].cost_per_hour / cap
                if cpr < best_cpr:
                    best, best_cpr = name, cpr
            if best is None:
                return Allocation({g: 0 for g in self.device_types}, 0.0,
                                  {}, feasible=False,
                                  note=f"bucket {d.bucket.key} unservable")
            g = self.device_types.index(best)
            load_per_dev[best] += d.rps * self.headroom / caps[(i, g)]
            assignment[(d.bucket.key, best)] = d.rps
        counts = {}
        for name, load in load_per_dev.items():
            n = math.ceil(load)
            cap_limit = self.availability.get(name)
            if cap_limit is not None:
                n = min(n, cap_limit)
            counts[name] = n
        cost = sum(counts[n] * DEVICES[n].cost_per_hour for n in counts)
        return Allocation(counts, cost, assignment)

    # ----------------------------------------------- autoscaler interface
    def metric_source(self, demand: List[DemandBucket]) -> Dict[str, int]:
        """Desired replicas per device-typed deployment — the 'external
        MetricSource' the Pod Autoscaler reads (paper Figure 8)."""
        alloc = self.optimize(demand)
        return {f"deploy-{g}": n for g, n in alloc.counts.items()}

    # ----------------------------------------------- P/D role planner
    def split_roles(self, demand: List[DemandBucket], device: str,
                    total_engines: Optional[int] = None,
                    slo_ttft_s: Optional[float] = None,
                    slo_itl_s: Optional[float] = None,
                    headroom: float = 1.2) -> "RoleSplit":
        """Propose the initial P:D engine ratio for a disaggregated
        fleet (see module-level :func:`split_roles`)."""
        return split_roles(self.table, demand, device,
                           total_engines=total_engines,
                           slo_ttft_s=slo_ttft_s, slo_itl_s=slo_itl_s,
                           headroom=headroom)


@dataclass
class RoleSplit:
    """A proposed prefill:decode split with its load accounting."""
    n_prefill: int
    n_decode: int
    prefill_load: float       # prefill engine-equivalents demanded
    decode_load: float        # decode engine-equivalents demanded
    note: str = ""

    @property
    def spec(self) -> str:
        """The '<n>P<m>D' role spec the launcher / sim parse."""
        return f"{self.n_prefill}P{self.n_decode}D"


def split_roles(table: ProfileTable, demand: List[DemandBucket],
                device: str, total_engines: Optional[int] = None,
                slo_ttft_s: Optional[float] = None,
                slo_itl_s: Optional[float] = None,
                headroom: float = 1.2, max_batch: int = 32) -> RoleSplit:
    """SLO-aware P:D planner over the roofline profile.

    Prefill demand is compute-bound engine-seconds per second
    (``rps * prefill_time(in_len)``); decode demand is bandwidth-bound
    engine-seconds (``rps * out_len * step_time(b)/b`` at the largest
    batch whose ITL still meets the SLO target — the target CAPS
    batching, which is exactly why decode pods multiply under tight
    ITL).  Unconstrained, each side gets ``ceil(load*headroom)``
    engines; with ``total_engines`` the ratio is apportioned at a
    minimum of one engine per role.  The returned split seeds the
    RolePoolManager; live attainment then corrects the model error.
    """
    pm = PerfModel(table.cfg, DEVICES[device])
    ttft = slo_ttft_s if slo_ttft_s is not None else table.slo_ttft_s
    itl = slo_itl_s if slo_itl_s is not None else table.slo_itl_s
    p_load = d_load = 0.0
    notes = []
    for d in demand:
        if d.rps <= 0:
            continue
        b = d.bucket
        ctx = b.in_len + b.out_len / 2.0
        pt = pm.prefill_time(b.in_len)
        if ttft is not None and pt > ttft:
            notes.append(f"bucket {b.key}: prefill {pt:.2f}s > "
                         f"TTFT target {ttft:.2f}s")
        p_load += d.rps * pt
        batch = 1
        while (batch * 2 <= max_batch
               and (itl is None
                    or pm.decode_step_time(batch * 2, int(ctx)) <= itl)):
            batch *= 2
        d_load += (d.rps * b.out_len
                   * pm.decode_step_time(batch, int(ctx)) / batch)
    p_load *= headroom
    d_load *= headroom
    if total_engines is not None:
        total = int(total_engines)
        if total < 2:
            raise ValueError("split_roles: a disaggregated fleet needs "
                             f"total_engines >= 2, got {total}")
        share = p_load / max(p_load + d_load, 1e-9)
        n_p = min(max(int(round(total * share)), 1), total - 1)
        n_d = total - n_p
    else:
        n_p = max(math.ceil(p_load), 1)
        n_d = max(math.ceil(d_load), 1)
    return RoleSplit(n_p, n_d, p_load, d_load, note="; ".join(notes))


def homogeneous_cost(table: ProfileTable, demand: List[DemandBucket],
                     device: str, headroom: float = 1.2) -> Tuple[int, float]:
    """Baseline: serve everything on one device type."""
    load = 0.0
    for d in demand:
        cap = table.capacity(device, d.bucket)
        if cap <= 0:
            return 0, float("inf")
        load += d.rps * headroom / cap
    n = max(math.ceil(load), 1)
    return n, n * DEVICES[device].cost_per_hour
