"""Continuous-batching serving engine (counterpart of the JAX package's
``serving/``)."""
from repro_torch.serving.cache import CacheManager
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import (Request, RequestOutput, RequestQueue,
                                         SamplingParams)
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.telemetry import latency_summary

__all__ = ["CacheManager", "ServingEngine", "Request", "RequestOutput",
           "RequestQueue", "SamplingParams", "sample_tokens", "Scheduler",
           "SchedulerConfig", "latency_summary"]
