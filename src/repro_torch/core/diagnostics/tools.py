"""Accelerator diagnostics + failure mockup tools (paper §3.2.8, Fig 9).

* ``FailureInjector`` — the mock-up tool: deterministically injects
  hardware fault modes (ECC error, thermal throttle, link flap, silent
  degradation, device loss) into engine handles / telemetry streams so
  recovery paths can be exercised in tests (the paper supports NVIDIA
  GPUs and Ascend NPUs; our telemetry interface is vendor-neutral and
  would bind to libtpu health counters on the deployment target).

* ``DiagnosticMonitor`` — the detection tool: consumes standardized
  telemetry snapshots and flags anomalies with a rule set per fault
  mode; emits remediation actions the orchestrator applies (cordon,
  restart pod, drain).
"""
from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional


class FaultKind(Enum):
    ECC_ERROR = "ecc_error"
    THERMAL_THROTTLE = "thermal_throttle"
    LINK_FLAP = "link_flap"
    SILENT_DEGRADATION = "silent_degradation"
    DEVICE_LOST = "device_lost"


@dataclass
class Telemetry:
    """One telemetry sample per device (DCGM-field analogue)."""
    pod_id: str
    t: float
    temperature_c: float = 60.0
    ecc_sbe: int = 0                # single-bit errors (corrected)
    ecc_dbe: int = 0                # double-bit errors (fatal)
    sm_clock_mhz: float = 1500.0
    link_up: bool = True
    tokens_per_sec: float = 0.0
    heartbeat_ok: bool = True


@dataclass
class ActiveFault:
    kind: FaultKind
    pod_id: str
    started: float
    severity: float = 1.0


class FailureInjector:
    """Mock-up tool: wraps per-pod telemetry generation + engine effects."""

    def __init__(self):
        self.active: Dict[str, List[ActiveFault]] = {}

    def inject(self, pod_id: str, kind: FaultKind, now: float,
               severity: float = 1.0) -> ActiveFault:
        f = ActiveFault(kind, pod_id, now, severity)
        self.active.setdefault(pod_id, []).append(f)
        return f

    def clear(self, pod_id: str, kind: Optional[FaultKind] = None) -> None:
        if kind is None:
            self.active.pop(pod_id, None)
            return
        left = [f for f in self.active.get(pod_id, []) if f.kind != kind]
        if left:
            self.active[pod_id] = left
        else:
            # no empty-list tombstones: long chaos runs inject/clear
            # thousands of times and `active` must not grow unbounded
            self.active.pop(pod_id, None)

    # ---------------------------------------------------------- effects
    def perturb(self, sample: Telemetry) -> Telemetry:
        """Apply active faults to a clean telemetry sample."""
        for f in self.active.get(sample.pod_id, []):
            if f.kind == FaultKind.ECC_ERROR:
                sample.ecc_sbe += int(10 * f.severity)
                if f.severity >= 1.0:
                    sample.ecc_dbe += 1
            elif f.kind == FaultKind.THERMAL_THROTTLE:
                sample.temperature_c = 92.0 + 5 * f.severity
                sample.sm_clock_mhz *= (1 - 0.4 * f.severity)
                sample.tokens_per_sec *= (1 - 0.4 * f.severity)
            elif f.kind == FaultKind.LINK_FLAP:
                sample.link_up = (int(sample.t * 10) % 3) != 0
            elif f.kind == FaultKind.SILENT_DEGRADATION:
                sample.tokens_per_sec *= (1 - 0.5 * f.severity)
            elif f.kind == FaultKind.DEVICE_LOST:
                sample.heartbeat_ok = False
                sample.tokens_per_sec = 0.0
        return sample

    def slowdown_factor(self, pod_id: str) -> float:
        """Engine-visible speed multiplier (for the cluster simulator)."""
        s = 1.0
        for f in self.active.get(pod_id, []):
            if f.kind in (FaultKind.THERMAL_THROTTLE,
                          FaultKind.SILENT_DEGRADATION):
                s *= (1 - 0.4 * f.severity)
            if f.kind == FaultKind.DEVICE_LOST:
                s = 0.0
        return s


@dataclass
class Diagnosis:
    pod_id: str
    t: float
    fault: FaultKind
    evidence: str
    action: str         # cordon | restart | drain | observe | quarantine | readmit


class DiagnosticMonitor:
    """Rule-based detector over telemetry history (per pod), with
    hysteresis between detection and action.

    Hard faults (missed heartbeat, double-bit ECC) act on a single
    sample — there is no recovering from those in place.  Soft faults
    (thermal throttle, link flaps, silent degradation) must persist
    for ``confirm_n`` consecutive samples before the pod is
    *quarantined* (the orchestrator cordons it out of routing but
    keeps it alive).  A quarantined pod is re-admitted only after a
    probe passes: at least ``quarantine_s`` seconds cordoned AND
    ``readmit_n`` consecutive clean samples.  A pod still anomalous
    ``escalate_s`` seconds into quarantine escalates to ``restart``
    (replacement).  This keeps a flapping engine from oscillating
    between cordon and re-admit on every scrape.
    """

    def __init__(self, window: int = 30, tput_drop_ratio: float = 0.6,
                 confirm_n: int = 3, quarantine_s: float = 10.0,
                 readmit_n: int = 5, escalate_s: float = 60.0):
        self.window = window
        self.tput_drop = tput_drop_ratio
        self.confirm_n = confirm_n
        self.quarantine_s = quarantine_s
        self.readmit_n = readmit_n
        self.escalate_s = escalate_s
        self.history: Dict[str, Deque[Telemetry]] = {}
        self.baseline_tput: Dict[str, float] = {}
        self._streak: Dict[str, int] = {}       # consecutive anomalous samples
        self._clean: Dict[str, int] = {}        # consecutive clean samples
        self.quarantined: Dict[str, float] = {}  # pod -> quarantine start t
        self._qfault: Dict[str, FaultKind] = {}  # pod -> quarantining fault

    # ------------------------------------------------------------- rules
    def _rules(self, sample: Telemetry,
               h: "Deque[Telemetry]") -> List[Diagnosis]:
        """Raw per-sample findings (no hysteresis applied)."""
        out: List[Diagnosis] = []
        pid, t = sample.pod_id, sample.t
        if not sample.heartbeat_ok:
            out.append(Diagnosis(pid, t, FaultKind.DEVICE_LOST,
                                 "heartbeat missed", "restart"))
            return out
        if sample.ecc_dbe > 0:
            out.append(Diagnosis(pid, t, FaultKind.ECC_ERROR,
                                 f"{sample.ecc_dbe} double-bit ECC",
                                 "cordon"))
        elif sample.ecc_sbe > 50:
            out.append(Diagnosis(pid, t, FaultKind.ECC_ERROR,
                                 f"{sample.ecc_sbe} single-bit ECC (rate)",
                                 "observe"))
        if sample.temperature_c > 88 and sample.sm_clock_mhz < 1200:
            out.append(Diagnosis(pid, t, FaultKind.THERMAL_THROTTLE,
                                 f"{sample.temperature_c:.0f}C + clocks down",
                                 "drain"))
        flaps = sum(1 for s in h if not s.link_up)
        if flaps >= 3:
            out.append(Diagnosis(pid, t, FaultKind.LINK_FLAP,
                                 f"{flaps} link drops in window", "cordon"))
        # silent degradation: sustained throughput drop vs own baseline
        tputs = [s.tokens_per_sec for s in h if s.tokens_per_sec > 0]
        if len(tputs) >= 10:
            base = self.baseline_tput.setdefault(
                pid, statistics.median(tputs[:5]))
            recent = statistics.median(tputs[-5:])
            if base > 0 and recent < base * self.tput_drop:
                out.append(Diagnosis(
                    pid, t, FaultKind.SILENT_DEGRADATION,
                    f"tput {recent:.0f} < {self.tput_drop:.0%} of "
                    f"baseline {base:.0f}", "restart"))
        return out

    # ----------------------------------------------------- state machine
    def observe(self, sample: Telemetry) -> List[Diagnosis]:
        h = self.history.setdefault(
            sample.pod_id, collections.deque(maxlen=self.window))
        h.append(sample)
        pid, t = sample.pod_id, sample.t
        raw = self._rules(sample, h)

        hard = [d for d in raw if d.fault in (FaultKind.DEVICE_LOST,)
                or (d.fault == FaultKind.ECC_ERROR and d.action == "cordon")]
        soft = [d for d in raw if d not in hard]
        if hard:
            # terminal: the pod is being replaced, drop quarantine state
            self._forget(pid)
            return hard

        out: List[Diagnosis] = []
        since = self.quarantined.get(pid)
        if soft:
            self._clean[pid] = 0
            if since is None:
                streak = self._streak.get(pid, 0) + 1
                self._streak[pid] = streak
                if streak >= self.confirm_n:
                    self.quarantined[pid] = t
                    self._streak[pid] = 0
                    lead = soft[0]
                    self._qfault[pid] = lead.fault
                    out.append(Diagnosis(
                        pid, t, lead.fault,
                        f"{lead.evidence} ({streak} consecutive scrapes)",
                        "quarantine"))
            elif t - since >= self.escalate_s:
                # probe keeps failing well into quarantine: replace it
                self._forget(pid)
                out.append(Diagnosis(
                    pid, t, soft[0].fault,
                    f"still anomalous {t - since:.0f}s into quarantine",
                    "restart"))
        else:
            self._streak[pid] = 0
            if since is not None:
                clean = self._clean.get(pid, 0) + 1
                self._clean[pid] = clean
                if clean >= self.readmit_n and t - since >= self.quarantine_s:
                    fault = self._qfault.get(pid, FaultKind.SILENT_DEGRADATION)
                    self._forget(pid)
                    out.append(Diagnosis(
                        pid, t, fault,
                        f"probe passed: {clean} clean scrapes after "
                        f"{t - since:.0f}s quarantined", "readmit"))
        return out

    def _forget(self, pod_id: str) -> None:
        self.quarantined.pop(pod_id, None)
        self._qfault.pop(pod_id, None)
        self._streak.pop(pod_id, None)
        self._clean.pop(pod_id, None)
