"""Batched serving engine and the shared slot-admission machinery.

Counterpart of :mod:`repro.serving.engine`.  Continuous batching with a
fixed decode batch of slots: finished sequences release their slot, and
the scheduler admits queued requests by prefilling them into the free
slot.  The engine serves the families whose prefill takes tokens alone,
as the reference's does: ``dense``, ``moe``, ``ssm`` and ``hybrid``.  A
``vlm`` needs patch embeddings and an ``encdec`` frames, which neither
engine takes, so the port refuses them at construction.  Admission (:class:`AdmissionQueue`,
:func:`admission_key`) orders requests by priority, then deadline, then
arrival, and is not decode-specific (the solve service, still to be
ported, shares it in the reference).

The engine keeps its cache on its device (``"cuda"`` unless given
``device="cpu"``); the prefill writes every cache leaf of the slot in
place (K/V rows; an ssm's or hybrid's conv window and SSD state), and
every decode step runs all slots at their own positions.  Each
prefill's attention runs K8 on the card.  Sampling is greedy or
categorical (Gumbel-max) from the engine's seeded :class:`torch.Generator`;
the reference samples with ``jax.random``, so only greedy tokens can
match it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LanguageModel,
    decode_step,
    family_of,
    init_decode_cache,
    prefill_into,
)
from repro_torch.serving.faults import SolveError


def admission_key(item) -> tuple:
    """Slot-admission ordering shared by every serving front-end.

    Higher ``priority`` admits first; within a priority class requests
    order earliest-deadline-first (``deadline=None`` ranks after every
    deadlined request); ties break FIFO on the arrival stamp ``seq``.
    """
    d = getattr(item, "deadline", None)
    return (
        -getattr(item, "priority", 0),
        math.inf if d is None else float(d),
        getattr(item, "seq", 0),
    )


class AdmissionQueue:
    """Priority/deadline admission queue over slot-based serving loops.

    Items carry ``priority`` / ``deadline`` / ``seq`` attributes;
    :meth:`push` stamps the arrival ``seq`` so FIFO ties are stable.
    ``priority`` / ``deadline`` passed to :meth:`push` override the
    item's stamps; omitted, the item's own stamps are kept.
    :meth:`requeue` re-adds items with their original stamps (``seq``
    included), at their original admission rank.  Pops scan for the
    minimum: the queues are small and drain into slots every step.
    """

    _UNSET = object()

    def __init__(self) -> None:
        self._items: list = []
        self._seq = 0
        self._lock = threading.Lock()

    def push(self, item, *, priority=_UNSET, deadline=_UNSET):
        if priority is not self._UNSET:
            item.priority = priority
        if deadline is not self._UNSET:
            item.deadline = deadline
        with self._lock:
            item.seq = self._seq
            self._seq += 1
            self._items.append(item)
        return item

    def requeue(self, items: Iterable) -> None:
        """Re-admit items that keep their original admission stamps."""
        with self._lock:
            self._items.extend(items)

    def pop(self):
        """Remove and return the next item in admission order."""
        with self._lock:
            if not self._items:
                raise IndexError("pop from empty AdmissionQueue")
            best = min(range(len(self._items)),
                       key=lambda i: admission_key(self._items[i]))
            return self._items.pop(best)

    def pop_all(self) -> list:
        """Drain the whole queue in admission order."""
        with self._lock:
            out = sorted(self._items, key=admission_key)
            self._items.clear()
        return out

    def discard(self, pred: Callable[[Any], bool]) -> list:
        """Remove (and return) every item matching ``pred``."""
        with self._lock:
            dropped = [it for it in self._items if pred(it)]
            self._items = [it for it in self._items if not pred(it)]
        return dropped

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(sorted(self._items, key=admission_key))


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # structured failure (e.g. deadline_expired) instead of tokens;
    # a request always finishes exactly one way: out or error
    error: object | None = None
    # admission stamps (set by AdmissionQueue.push)
    priority: int = 0
    deadline: float | None = None
    seq: int = 0


# the families a prefill of tokens alone serves (the reference engine's)
SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


class ServeEngine:
    """Continuous-batching server for a model on one device.

    ``params`` must live on ``device`` (default ``"cuda"``; raises
    without a card unless given ``device="cpu"``).  ``fault_injector``
    (:class:`repro_torch.serving.faults.FaultInjector`) is drawn once per
    decode step: an injected device fault turns the step into a counted
    no-op retry (``faulted_steps``), a slow fault stalls it.  Deadlines
    are absolute ``time.monotonic()`` stamps, enforced at admission.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: LanguageModel,
        *,
        batch_slots: int = 4,
        max_seq: int = 512,
        sampler: str = "greedy",
        temperature: float = 1.0,
        seed: int = 0,
        fault_injector=None,
        device=None,
    ):
        if sampler not in ("greedy", "categorical"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if family_of(cfg) not in SERVED_FAMILIES:
            raise ValueError(
                f"ServeEngine serves {SERVED_FAMILIES}, not the {cfg.family!r} family of "
                f"{cfg.arch_id}: its prefill needs "
                f"{'patches' if cfg.family == 'vlm' else 'frames'} beside the tokens; "
                "call models.model.prefill and decode_step directly")
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.device}, the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.sampler = sampler
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fault_injector = fault_injector
        self.faulted_steps = 0
        self.expired = 0

        self.cache = init_decode_cache(cfg, batch_slots, max_seq, device=self.device)
        self.pos = np.zeros(batch_slots, dtype=np.int64)     # per-slot length
        self.active: list[Optional[Request]] = [None] * batch_slots
        self.queue = AdmissionQueue()

    # ----------------------------------------------------------- scheduling
    def submit(self, req: Request, *, priority=AdmissionQueue._UNSET,
               deadline=AdmissionQueue._UNSET):
        self.queue.push(req, priority=priority, deadline=deadline)

    def _admit(self):
        for slot in range(self.slots):
            while self.active[slot] is None and self.queue:
                req = self.queue.pop()
                # an expired request is rejected with a structured error,
                # never prefilled
                if req.deadline is not None and time.monotonic() >= req.deadline:
                    req.done = True
                    req.error = SolveError(kind="deadline_expired")
                    self.expired += 1
                    continue
                self._prefill_slot(slot, req)

    def _prefill_slot(self, slot: int, req: Request):
        """Single-sequence prefill written into the slot's cache rows."""
        tokens = np.asarray(req.prompt, dtype=np.int64)[None, :]
        logits = prefill_into(self.params, tokens, self.cfg, self.cache, slot)
        self.pos[slot] = tokens.shape[1]
        req.out.append(int(self._sample(logits)[0]))
        self.active[slot] = req

    @torch.inference_mode()
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.sampler == "greedy":
            return logits.argmax(dim=-1).cpu().numpy()
        # Gumbel-max: argmax(logits / T + G), G = -log(-log(U)), U in (0, 1)
        u = torch.rand(logits.shape, generator=self.generator, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return (logits.float() / self.temperature + gumbel).argmax(dim=-1).cpu().numpy()

    # ----------------------------------------------------------- decoding
    def _decode_active(self):
        """One decode step of every slot at its own position; sample."""
        toks = np.zeros((self.slots, 1), dtype=np.int64)
        for s, req in enumerate(self.active):
            if req is not None and req.out:
                toks[s, 0] = req.out[-1]
        logits, self.cache = decode_step(self.params, toks, self.pos, self.cache, self.cfg)
        return self._sample(logits)

    def step(self):
        """One decode step across every active slot.

        Under an armed fault injector a ``device_fault`` draw turns this
        step into a counted no-op (slot state untouched: the next step
        retries the same decode), and a ``slow`` draw stalls it;
        :meth:`run`'s ``max_steps`` is the retry budget.
        """
        self._admit()
        if not any(r is not None for r in self.active):
            return
        if self.fault_injector is not None:
            kind = self.fault_injector.draw()
            if kind in ("device_fault", "build_error", "nonfinite"):
                self.faulted_steps += 1
                return
            if kind == "slow":
                # the injected-slow chaos fault: stalling is the fault
                # being simulated, so the block here is deliberate
                time.sleep(  # repro: ignore[blocking-call-in-stream-loop]
                    self.fault_injector.plan.slow_s)
        nxt = self._decode_active()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            # nxt is numpy: _sample made the step's one host copy
            # repro: ignore[host-sync-in-hot-path]
            req.out.append(int(nxt[s]))
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                req.done = True
                self.active[s] = None

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            if not self.queue and not any(self.active):
                break
            self.step()
