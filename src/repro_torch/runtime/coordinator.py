"""Cluster coordination: failure detection, elastic rescale, stragglers.

The reference package's ``repro.runtime.coordinator``, pure Python, kept
here as the port's own copy (it imports nothing of either package): the
same classes, the same decisions, the same event log.

FeatInsight gets HA from ZooKeeper; a training fleet gets it from a
coordinator of exactly this shape.  There is no real cluster here, so
hosts are simulated — the *protocol* is implemented and unit-tested:

* **HeartbeatTracker** — hosts report heartbeats; a host silent for
  ``timeout`` is declared failed (phi-accrual simplified to a hard
  deadline; the clock is injected for determinism).
* **ElasticPlanner** — given surviving hosts and the mesh template,
  produce the largest runnable mesh (shrink the data axis to the largest
  feasible size; the model axis is sacred — TP shards are not
  reconstructible without a full reshard) + the checkpoint-reshard plan.
* **StragglerMonitor** — per-host step-time EWMA; hosts slower than
  ``k x`` the fleet median are flagged for replacement (the scheduler
  drains them at the next checkpoint boundary rather than killing the
  step — synchronous SPMD cannot drop a participant mid-step).
* **TrainSupervisor** — the restart loop: run -> on failure, plan ->
  restore latest checkpoint (resharded) -> continue, around any
  checkpoint manager with ``save`` / ``latest_step`` / ``restore(step,
  like=...)`` (:class:`repro_torch.ckpt.manifest.CheckpointManager`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HeartbeatTracker", "ElasticPlanner", "StragglerMonitor",
    "TrainSupervisor", "MeshTemplate", "RescalePlan",
]


class HeartbeatTracker:
    def __init__(self, hosts: Sequence[str], timeout: float, now: Callable[[], float]):
        self._now = now
        self.timeout = timeout
        self.last: Dict[str, float] = {h: now() for h in hosts}

    def beat(self, host: str) -> None:
        self.last[host] = self._now()

    def failed(self) -> List[str]:
        t = self._now()
        return [h for h, last in self.last.items() if t - last > self.timeout]

    def alive(self) -> List[str]:
        t = self._now()
        return [h for h, last in self.last.items() if t - last <= self.timeout]

    def remove(self, host: str) -> None:
        self.last.pop(host, None)


@dataclasses.dataclass(frozen=True)
class MeshTemplate:
    data: int
    model: int
    pods: int = 1
    hosts_per_data_slice: int = 1  # hosts needed per data-axis unit


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    new_data: int
    new_model: int
    new_pods: int
    dropped_hosts: Tuple[str, ...]
    batch_scale: float          # global batch multiplier (keep per-replica fixed)
    needs_reshard: bool

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        if self.new_pods > 1:
            return (self.new_pods, self.new_data, self.new_model)
        return (self.new_data, self.new_model)


class ElasticPlanner:
    """Shrink the data axis to fit surviving hosts (powers-of-two ladder)."""

    def __init__(self, template: MeshTemplate):
        self.template = template

    def plan(self, alive_hosts: int, failed: Sequence[str] = ()) -> Optional[RescalePlan]:
        t = self.template
        hosts_needed_per_data = t.hosts_per_data_slice
        max_data = alive_hosts // (hosts_needed_per_data * t.pods)
        data = t.data
        while data > max_data:
            data //= 2
        if data < 1:
            return None  # not enough hosts for even one slice
        return RescalePlan(
            new_data=data,
            new_model=t.model,            # TP untouched
            new_pods=t.pods,
            dropped_hosts=tuple(failed),
            batch_scale=data / t.data,
            needs_reshard=data != t.data,
        )


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, alpha: float = 0.3):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}

    def record(self, host: str, step_time: float) -> None:
        prev = self.ewma.get(host)
        self.ewma[host] = (
            step_time if prev is None
            else self.alpha * step_time + (1 - self.alpha) * prev
        )

    def stragglers(self) -> List[str]:
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        return [
            h for h, v in self.ewma.items() if v > self.threshold * median
        ]


class TrainSupervisor:
    """Checkpoint/restart loop around a step function (simulated hosts).

    run() executes steps; injected failures raise HostFailure; the
    supervisor detects, plans a rescale, restores from the checkpoint
    manager and continues until target_steps.
    """

    class HostFailure(RuntimeError):
        def __init__(self, host: str):
            super().__init__(f"host {host} failed")
            self.host = host

    def __init__(
        self,
        planner: ElasticPlanner,
        ckpt,                       # CheckpointManager-like
        make_state: Callable[[], object],
        step_fn: Callable[[object, int, RescalePlan], object],
        ckpt_every: int = 10,
    ):
        self.planner = planner
        self.ckpt = ckpt
        self.make_state = make_state
        self.step_fn = step_fn
        self.ckpt_every = ckpt_every
        self.events: List[Dict] = []

    def run(self, target_steps: int, total_hosts: int) -> Tuple[object, Dict]:
        alive = total_hosts
        plan = self.planner.plan(alive)
        assert plan is not None
        state = self.make_state()
        step = 0
        restarts = 0
        while step < target_steps:
            try:
                state = self.step_fn(state, step, plan)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, blocking=True)
                    self.events.append({"kind": "ckpt", "step": step})
            except TrainSupervisor.HostFailure as f:
                restarts += 1
                alive -= 1
                self.events.append({"kind": "failure", "host": f.host,
                                    "step": step})
                new_plan = self.planner.plan(alive, failed=(f.host,))
                if new_plan is None:
                    raise RuntimeError("insufficient hosts to continue")
                plan = new_plan
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state = self.ckpt.restore(latest, like=state)
                    step = latest
                else:
                    state = self.make_state()
                    step = 0
                self.events.append({
                    "kind": "rescale", "step": step,
                    "mesh": plan.mesh_shape, "reshard": plan.needs_reshard,
                })
        return state, {"restarts": restarts, "final_step": step,
                       "plan": plan, "events": self.events}
