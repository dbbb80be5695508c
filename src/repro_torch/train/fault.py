"""Fault tolerance: heartbeats, failure detection, restart planning (port
of ``repro.train.fault``).

Each host runs a ``Heartbeat`` writer and the coordinator a
``FleetMonitor``; on one card the same logic runs in one process.

  * every host touches  <dir>/hb_<host>.json  every ``interval`` seconds
  * a host is DEAD if its heartbeat is older than ``timeout``
  * on death the monitor returns a RestartPlan: the newest committed
    checkpoint and the surviving host set (elastic: the data-parallel
    extent shrinks, the model extent stays)
  * stragglers (heartbeat fresh but step counter stale against the fleet
    median) are reported for eviction

``deterministic_data_key`` is ``data.lm_data``'s, the one definition both
use.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

from repro_torch.data.lm_data import deterministic_data_key
from repro_torch.train import checkpoint as ckpt

__all__ = ["FleetMonitor", "Heartbeat", "HostState", "RestartPlan",
           "deterministic_data_key"]


@dataclasses.dataclass
class HostState:
    host: str
    last_beat: float
    step: int


class Heartbeat:
    def __init__(self, directory: str, host: str):
        self.path = Path(directory) / f"hb_{host}.json"
        self.host = host

    def beat(self, step: int) -> None:
        self.path.write_text(json.dumps(
            {"host": self.host, "time": time.time(), "step": step}))


@dataclasses.dataclass
class RestartPlan:
    restore_step: int | None
    alive_hosts: list[str]
    dead_hosts: list[str]
    stragglers: list[str]
    new_data_extent: int


class FleetMonitor:
    """Coordinator-side failure detection and elastic restart planning."""

    def __init__(self, directory: str, *, timeout: float = 60.0,
                 straggler_factor: float = 0.5):
        self.dir = Path(directory)
        self.timeout = timeout
        self.straggler_factor = straggler_factor

    def poll(self) -> list[HostState]:
        out = []
        for p in self.dir.glob("hb_*.json"):
            try:
                d = json.loads(p.read_text())
                out.append(HostState(d["host"], d["time"], d["step"]))
            except (json.JSONDecodeError, KeyError):
                continue   # torn write: treat as missing this round
        return out

    def plan(self, *, now: float | None = None,
             model_extent: int = 16, chips_per_host: int = 4) -> RestartPlan:
        now = time.time() if now is None else now
        hosts = self.poll()
        alive = [h for h in hosts if now - h.last_beat <= self.timeout]
        dead = [h for h in hosts if now - h.last_beat > self.timeout]
        steps = sorted(h.step for h in alive)
        median = steps[len(steps) // 2] if steps else 0
        stragglers = [h.host for h in alive
                      if median > 10 and h.step < median * self.straggler_factor]
        # elastic: the data axis shrinks to what the alive hosts support;
        # the model axis is fixed by the sharded parameter layout
        total_chips = len(alive) * chips_per_host
        new_data = max(1, total_chips // model_extent)
        return RestartPlan(
            restore_step=ckpt.latest_step(self.dir),
            alive_hosts=sorted(h.host for h in alive),
            dead_hosts=sorted(h.host for h in dead),
            stragglers=stragglers,
            new_data_extent=new_data,
        )
