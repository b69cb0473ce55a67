"""Elastic scaling and straggler policy for multi-pod training.

Port of ``repro/train/elastic.py``, which is numpy and host-side: the same
code.  On node failure (or a planned resize) the runtime picks a new mesh
from the surviving hosts, re-shards the checkpointed state onto it, and
resumes the data stream where it stopped:

* ``plan_mesh`` -- the largest valid (pod, data, model) factorisation of
  the surviving chip count, keeping the model axis and shedding
  data-parallel replicas;
* ``remesh_plan`` -- what changes: dp size, recompilation, resharding;
* ``StragglerMonitor`` -- ET-x telemetry: a host reports its step time
  only when it drifts more than x standard deviations from its last
  report, and persistent stragglers are proposed for eviction.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pods: int
    data: int
    model: int
    dropped_chips: int

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


def plan_mesh(
    available_chips: int,
    *,
    model_axis: int = 16,
    chips_per_pod: int = 256,
    global_batch: int = 256,
) -> MeshPlan:
    """Largest usable mesh: keep TP fixed, shrink DP to what divides."""
    if available_chips < model_axis:
        raise ValueError(f"need at least {model_axis} chips (TP axis)")
    pods = max(available_chips // chips_per_pod, 1)
    per_pod = min(available_chips // pods, chips_per_pod)
    data = per_pod // model_axis
    # dp must divide the global batch to keep the stream re-shardable
    while data > 1 and global_batch % (data * pods):
        data -= 1
    used = pods * data * model_axis
    return MeshPlan(
        pods=pods, data=data, model=model_axis,
        dropped_chips=available_chips - used,
    )


def remesh_plan(old: MeshPlan, new: MeshPlan) -> dict:
    return {
        "recompile": (old.model != new.model) or (old.data != new.data)
        or (old.pods != new.pods),
        "dp_old": old.pods * old.data,
        "dp_new": new.pods * new.data,
        "reshard_params": old.model != new.model,
        "chips": (old.chips, new.chips),
    }


class StragglerMonitor:
    """ET-x telemetry: hosts report step time only on significant drift."""

    def __init__(self, num_hosts: int, et_threshold: float = 3.0,
                 evict_after: int = 5, slow_factor: float = 1.5):
        self.approx = np.zeros(num_hosts)  # balancer-side approximation
        self.et_threshold = et_threshold
        self.evict_after = evict_after
        self.slow_factor = slow_factor
        self.strikes = np.zeros(num_hosts, dtype=int)
        self.messages = 0
        self.observations = 0

    def host_report(self, host: int, step_time: float) -> bool:
        """Host-side trigger: report iff |obs - approx| > x * sigma.

        A host's first observation always reports (the monitor has no state
        to emulate from).  Returns True if a message was sent.
        """
        self.observations += 1
        sigma = max(self.approx.std(), 1e-3)
        first = self.approx[host] == 0
        if first or abs(step_time - self.approx[host]) > self.et_threshold * sigma:
            self.approx[host] = step_time
            self.messages += 1
            return True
        return False

    def evictions(self) -> list[int]:
        """Hosts persistently slower than slow_factor x median."""
        med = np.median(self.approx[self.approx > 0]) if (self.approx > 0).any() else 0
        if med <= 0:
            return []
        slow = self.approx > self.slow_factor * med
        self.strikes = np.where(slow, self.strikes + 1, 0)
        return [int(h) for h in np.nonzero(self.strikes >= self.evict_after)[0]]

    @property
    def message_rate(self) -> float:
        return self.messages / max(self.observations, 1)
