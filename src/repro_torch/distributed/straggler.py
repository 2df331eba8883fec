"""Straggler mitigation (host-level, coordinator-side); a copy of
:mod:`repro.distributed.straggler`, which is pure host code.

At thousands of nodes the step time is the max over workers; slow
hosts (thermal throttling, flaky NICs, background daemons) dominate.
Mechanisms here (exercised in simulation by the tests):

* **Deadline tracker** — per-step wall-time EWMA + deviation; a worker
  whose heartbeat exceeds ``mean + k * dev`` is flagged.
* **Re-dispatch policy** — flagged workers' microbatches are reassigned
  to the fastest idle workers for the next accumulation round (work
  stealing at the grad-accum granularity; the global batch is
  preserved).
* **Eviction policy** — a worker flagged for ``evict_after``
  consecutive steps is handed to the elastic layer
  (:mod:`repro_torch.distributed.elastic`) for mesh reconstruction.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerConfig:
    k_dev: float = 3.0           # flag threshold in deviations
    ewma: float = 0.9
    evict_after: int = 5
    min_samples: int = 8


class StragglerTracker:
    def __init__(self, n_workers: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.n = n_workers
        self.mean = [0.0] * n_workers
        self.dev = [0.0] * n_workers
        self.samples = [0] * n_workers
        self.flag_streak = [0] * n_workers

    def observe(self, worker: int, step_time: float) -> None:
        a = self.cfg.ewma
        if self.samples[worker] == 0:
            self.mean[worker] = step_time
            self.dev[worker] = 0.0
        else:
            err = step_time - self.mean[worker]
            self.mean[worker] = a * self.mean[worker] + (1 - a) * step_time
            self.dev[worker] = a * self.dev[worker] + (1 - a) * abs(err)
        self.samples[worker] += 1

    def fleet_mean(self) -> float:
        act = [m for m, s in zip(self.mean, self.samples) if s > 0]
        return sum(act) / len(act) if act else 0.0

    def fleet_dev(self) -> float:
        act = [d for d, s in zip(self.dev, self.samples) if s > 0]
        return max(sum(act) / len(act), 1e-9) if act else 1e-9

    def stragglers(self) -> list[int]:
        """Workers currently beyond mean + k*dev of the fleet."""
        if min(self.samples) < self.cfg.min_samples:
            return []
        thresh = self.fleet_mean() + self.cfg.k_dev * self.fleet_dev()
        out = []
        for w in range(self.n):
            if self.mean[w] > thresh:
                self.flag_streak[w] += 1
                out.append(w)
            else:
                self.flag_streak[w] = 0
        return out

    def to_evict(self) -> list[int]:
        return [w for w in range(self.n)
                if self.flag_streak[w] >= self.cfg.evict_after]

    def reassign(self, microbatches: dict[int, list[int]]) -> dict[int, list[int]]:
        """Move flagged workers' microbatches onto the fastest workers.

        microbatches: worker -> list of microbatch ids for this round.
        Returns the re-balanced assignment (global batch preserved).
        """
        flagged = set(self.stragglers())
        if not flagged:
            return microbatches
        donors = sorted(
            (w for w in microbatches if w not in flagged),
            key=lambda w: self.mean[w],
        )
        if not donors:
            return microbatches
        out = {w: list(v) for w, v in microbatches.items()}
        moved = []
        for w in flagged:
            if w in out and len(out[w]) > 1:
                moved.extend(out[w][1:])      # keep one, shed the rest
                out[w] = out[w][:1]
        for i, mb in enumerate(moved):
            out[donors[i % len(donors)]].append(mb)
        return out
