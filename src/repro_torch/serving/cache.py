"""Slot/page cache manager for the continuous-batching engine (counterpart
of the JAX package's ``serving/cache.py``).

Physical layout is ONE batched cache tree (``init_cache(cfg, n_slots,
max_len)``): every leaf is (n_layers, n_slots, ...), so the batched decode
step runs over all slots in one call.  On top of that sit two accounting
layers:

* **KV pages** — attention layers consume ``ceil(len / page_size)`` pages
  per slot from a global pool.  Admission reserves the worst case (prompt
  + max_new tokens) up front, so an admitted request never runs out of
  cache mid-flight and no eviction path is needed.
* **SSM state slots** — recurrent leaves (mamba2 ``h``/``conv``) are
  fixed-size and length-independent: one state page per slot.  Hybrids
  (zamba2) pay both: KV pages for their shared attention plus one state
  page.

Slot reset writes a freshly initialised single-slot cache (zeros, kpos
−1) into the slot's row.  Where the reference donates the cache to a
jitted update, the port writes the slot's row in place (``copy_``); the
decode steps themselves return new cache tensors.
"""
from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, MOE, SHARED_ATTN,
                                      SLSTM, ModelConfig)
from repro_torch.core.tree import tree_map
from repro_torch.models.registry import get_model

_ATTN_KINDS = {ATTN, MOE, SHARED_ATTN}
_SSM_KINDS = {MAMBA2, MLSTM, SLSTM}


def _write_slot(cache, part, slot: int) -> None:
    """Copy the batch-1 tree ``part`` into row ``slot`` of ``cache``, in
    place."""
    tree_map(lambda leaf, p: leaf[:, slot].copy_(p[:, 0]), cache, part)


def _slice_slot(cache, slot: int):
    """Row ``slot`` of every leaf as a batch-1 view."""
    return tree_map(lambda leaf: leaf[:, slot:slot + 1], cache)


class CacheManager:
    def __init__(self, mcfg: ModelConfig, n_slots: int, max_len: int,
                 page_size: int = 64, dtype=torch.float32,
                 total_pages: int = None, device=None):
        self.mcfg, self.n_slots, self.max_len = mcfg, n_slots, max_len
        self.page_size = page_size
        kinds = set(mcfg.blocks())
        self.has_kv = bool(kinds & _ATTN_KINDS)
        self.has_state = bool(kinds & _SSM_KINDS)
        model = get_model(mcfg)
        self.cache = model.init_cache(mcfg, n_slots, max_len, dtype, device)
        self._fresh = model.init_cache(mcfg, 1, max_len, dtype, device)
        if total_pages is None:
            total_pages = n_slots * self.pages_for(max_len)
        self.total_pages = total_pages
        self.free_pages = total_pages
        self.slot_pages: List[int] = [0] * n_slots
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))

    # -- page accounting ---------------------------------------------------
    def pages_for(self, length: int) -> int:
        """Pages a sequence of ``length`` tokens occupies in this arch's
        cache: KV pages (capped at the physical ring size) + one
        fixed-size state page for recurrent layers."""
        pages = 0
        if self.has_kv:
            eff = min(length, self.max_len)
            pages += math.ceil(max(eff, 1) / self.page_size)
        if self.has_state:
            pages += 1
        return pages

    def can_admit(self, total_len: int) -> bool:
        return (bool(self._free_slots)
                and self.pages_for(total_len) <= self.free_pages)

    # -- slot lifecycle ----------------------------------------------------
    def admit(self, total_len: int) -> int:
        """Reserve a slot + pages for a request of ``total_len`` tokens
        (prompt + max_new) and reset the slot's cache row."""
        if not self.can_admit(total_len):
            raise RuntimeError("admit() called with no capacity; "
                               "check can_admit() first")
        slot = self._free_slots.pop()
        pages = self.pages_for(total_len)
        self.slot_pages[slot] = pages
        self.free_pages -= pages
        _write_slot(self.cache, self._fresh, slot)
        return slot

    def free(self, slot: int) -> None:
        self.free_pages += self.slot_pages[slot]
        self.slot_pages[slot] = 0
        self._free_slots.append(slot)

    # -- slot I/O for chunked prefill --------------------------------------
    def slot_view(self, slot: int):
        """The slot's (batch 1) cache slice, for the prefill-chunk step."""
        return _slice_slot(self.cache, slot)

    def write_slot(self, slot: int, part) -> None:
        _write_slot(self.cache, part, slot)
