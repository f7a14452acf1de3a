"""Request types + FIFO admission queue for the continuous-batching engine
(a copy of the JAX package's ``serving/request.py``, which imports no JAX).

A request's lifecycle: QUEUED (waiting for a slot) -> PREFILL (prompt being
ingested chunk-by-chunk) -> DECODE (in the batched decode set) -> FINISHED.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling.  temperature<=0 means greedy (argmax);
    top_k<=0 means no top-k truncation.  ``seed`` keys a per-request,
    per-position PRNG stream, so stochastic sampling for a request is
    reproducible regardless of what else shares the batch."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival_t: float = 0.0

    # progress (engine-owned)
    state: str = QUEUED
    slot: Optional[int] = None
    prefilled: int = 0                       # prompt tokens ingested
    out_tokens: List[int] = field(default_factory=list)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None


@dataclass(frozen=True)
class RequestOutput:
    rid: int
    prompt: List[int]
    tokens: List[int]
    arrival_t: float
    first_token_t: float
    finish_t: float

    @property
    def latency(self) -> float:
        return self.finish_t - self.arrival_t

    @property
    def ttft(self) -> float:
        """Time to first token."""
        return self.first_token_t - self.arrival_t

    @property
    def itl(self) -> Optional[float]:
        """Mean inter-token latency; None for single-token requests (no
        gap exists)."""
        if len(self.tokens) < 2:
            return None
        return (self.finish_t - self.first_token_t) / (len(self.tokens) - 1)


class RequestQueue:
    """FIFO admission queue."""

    def __init__(self):
        self._q: deque = deque()

    def add(self, req: Request) -> None:
        self._q.append(req)

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
