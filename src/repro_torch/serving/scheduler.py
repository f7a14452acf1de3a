"""Continuous-batching scheduler: admission + per-step work selection (a
copy of the JAX package's ``serving/scheduler.py``).

Policy, in one place:

* **Admission** — FIFO, no reordering: the queue head is admitted as soon
  as a slot is free AND the cache can reserve its worst-case footprint
  (prompt + max_new tokens).  Head-of-line blocking is deliberate; it
  keeps per-request latency predictable under overload.
* **Prefill-chunking** — per engine step, at most ONE chunk of ONE
  prefilling request is ingested (round-robin over prefilling slots),
  then every in-flight request decodes one token.  A 32k prompt therefore
  delays each decode step by one chunk (``prefill_chunk`` tokens), never
  by the whole prompt.
* **Decode** — all DECODE slots advance together in a single batched call;
  free/prefilling slots ride along masked-inactive.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.serving.cache import CacheManager
from repro_torch.serving.request import (DECODE, PREFILL, Request, RequestQueue)


@dataclass(frozen=True)
class SchedulerConfig:
    n_slots: int = 8
    max_len: int = 256           # per-slot cache capacity (tokens)
    prefill_chunk: int = 16      # prompt tokens ingested per engine step
    page_size: int = 64          # tokens per KV page (accounting granule)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, cachemgr: CacheManager):
        self.cfg = cfg
        self.cachemgr = cachemgr
        self.queue = RequestQueue()
        self.slots: List[Optional[Request]] = [None] * cfg.n_slots
        self._prefill_rr = 0

    def submit(self, req: Request) -> None:
        self.queue.add(req)

    def admit_ready(self) -> List[Request]:
        """Admit queue-head requests while slot + page capacity lasts."""
        admitted = []
        while self.queue:
            head = self.queue.peek()
            total = len(head.prompt) + head.max_new_tokens
            if not self.cachemgr.can_admit(total):
                break
            req = self.queue.pop()
            req.slot = self.cachemgr.admit(total)
            req.state = PREFILL
            self.slots[req.slot] = req
            admitted.append(req)
        return admitted

    def next_prefill(self) -> Optional[Request]:
        """Round-robin over slots still ingesting their prompt."""
        n = self.cfg.n_slots
        for off in range(n):
            slot = (self._prefill_rr + off) % n
            req = self.slots[slot]
            if req is not None and req.state == PREFILL:
                self._prefill_rr = (slot + 1) % n
                return req
        return None

    def decode_requests(self) -> List[Tuple[int, Request]]:
        return [(s, r) for s, r in enumerate(self.slots)
                if r is not None and r.state == DECODE]

    def release(self, req: Request) -> None:
        self.slots[req.slot] = None
        self.cachemgr.free(req.slot)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
