"""Memory-bounded paged backend for the per-client store (counterpart of
the JAX package's ``federated/fleet/paged_store.py``).

Per-client EF residuals and strategy state for a large fleet cannot all
stay resident: one fp32 EF residual of the paper CNN at width 32 is
2,676,008 bytes.  ``PagedClientStore`` duck-types ``ClientStore``
(register / gather / scatter / states / namespaces) behind a two-tier page
table:

* **resident tier** — one page per (namespace, client id): a tree of
  tensors on the device its namespace's fresh state lives on, in an
  ``OrderedDict`` in LRU order, under a hard ``budget_bytes`` ceiling on
  the summed tensor bytes.  Admitting a page past the budget first evicts
  from the LRU end until it fits.
* **spill tier** — an evicted page is copied to the host leaf by leaf, its
  bits viewed through ``checkpointing.storage_view`` (the uint view that
  makes bf16 and fp8 checkpoints round-trip) and zlib-compressed, kept in
  memory or, with ``spill_dir``, written to one file per page.  A fault
  decompresses, views the bits back as the leaf dtype, copies the page to
  its device and re-admits it: the round trip is bit for bit.

Gather stacks the picks' pages on the device (a fresh state for an empty
slot); scatter clones each pick's row, so a page owns its bytes and does
not keep the whole stacked round alive.  The values equal the plain
``ClientStore``'s bit for bit.

Gauges and counters ride the shared ``Counters`` registry, as the
reference publishes them: ``store.resident_pages``,
``store.resident_bytes`` and ``store.spilled_pages`` (gauges),
``store.spills`` and ``store.loads`` (counts).
"""
from __future__ import annotations

import os
import zlib
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpointing.checkpoint import (from_storage_view,
                                                  storage_dtype,
                                                  storage_view)
from repro_torch.core import tree as T

PageKey = Tuple[str, int]

# zlib level of every spilled page: the fastest level (PERF.md §7 weighs
# what it saves against what it costs a page)
COMPRESS_LEVEL = 1


def page_nbytes(page) -> int:
    """Resident cost of one page: the summed bytes of its leaves."""
    return sum(int(leaf.numel()) * leaf.element_size()
               for leaf in T.leaves(page))


def _unflatten(template, leaves):
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), template)


class _NamespaceView(MutableMapping):
    """Dict-like view of one namespace keyed by client id — the
    ``ClientStore.states`` surface, read and written through the page table
    (a read may fault a spilled page in; a write admits and may evict)."""

    def __init__(self, store: "PagedClientStore", name: str):
        self._store = store
        self._name = name

    def __getitem__(self, cid: int):
        page = self._store._load(self._name, int(cid))
        if page is None:
            raise KeyError(cid)
        return page

    def __setitem__(self, cid: int, value) -> None:
        self._store._put(self._name, int(cid), value)

    def __delitem__(self, cid: int) -> None:
        self._store._drop(self._name, int(cid))

    def __iter__(self):
        return iter(self._store._client_ids(self._name))

    def __len__(self) -> int:
        return len(self._store._client_ids(self._name))

    def __contains__(self, cid) -> bool:
        return int(cid) in self._store._client_ids(self._name)


class PagedClientStore:
    """Device page table with LRU spill to the host under a hard
    resident-bytes budget; a drop-in for ``ClientStore`` wherever an engine
    takes ``store=``."""

    def __init__(self, budget_bytes: int, counters=None,
                 spill_dir: Optional[str] = None):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.counters = counters
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._init: Dict[str, Callable[[], Any]] = {}
        self._template: Dict[str, Any] = {}
        # ns -> [(shape, dtype, device)] of the template's leaves
        self._specs: Dict[str, Any] = {}
        # the page table is the bound: resident pages evict to the spill
        # map past the budget, and a load pops its spill entry
        self._resident: "OrderedDict[PageKey, Any]" = OrderedDict()
        self._spilled: Dict[PageKey, Any] = {}
        self._resident_bytes = 0
        self._peak_resident_bytes = 0

    # --- ClientStore interface -------------------------------------------
    def register(self, name: str, init_fn: Callable[[], Any]) -> None:
        self._init[name] = init_fn
        self._template.pop(name, None)
        self._specs.pop(name, None)

    def namespaces(self):
        return tuple(self._init)

    def states(self, name: str) -> _NamespaceView:
        if name not in self._init:
            raise KeyError(name)
        return _NamespaceView(self, name)

    def gather(self, name: str, picks: Sequence[int]):
        """Stack the picks' pages (the fresh state for empty slots) into
        one tree with leading axis len(picks)."""
        tmpl = self._ns_template(name)
        pages = []
        for c in picks:
            page = self._load(name, int(c))
            pages.append(tmpl if page is None else page)
        return T.tree_map(lambda *xs: torch.stack(xs), *pages)

    def scatter(self, name: str, picks: Sequence[int], stacked) -> None:
        """Admit each pick's row of the stacked tree as its page (evicting
        LRU pages past the budget)."""
        for j, c in enumerate(picks):
            # clone, so the page owns its bytes: a bare x[j] view keeps the
            # whole stacked round alive behind every page
            page = T.tree_map(lambda x: x[j].clone(), stacked)
            self._admit((name, int(c)), page)

    # --- gauges -----------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    @property
    def peak_resident_bytes(self) -> int:
        """High-water mark of resident bytes (evictions run before a page
        is admitted, so it is the peak the budget is held to)."""
        return self._peak_resident_bytes

    @property
    def resident_pages(self) -> int:
        return len(self._resident)

    @property
    def spilled_pages(self) -> int:
        return len(self._spilled)

    # --- page table -------------------------------------------------------
    def _ns_template(self, name: str):
        if name not in self._template:
            tmpl = self._init[name]()
            self._template[name] = tmpl
            self._specs[name] = [(tuple(x.shape), x.dtype, x.device)
                                 for x in T.leaves(tmpl)]
        return self._template[name]

    def _client_ids(self, name: str):
        ids = {cid for ns, cid in self._resident if ns == name}
        ids.update(cid for ns, cid in self._spilled if ns == name)
        return sorted(ids)

    def _load(self, name: str, cid: int):
        """The page for (name, cid), faulting it in from the spill tier;
        None when the client has no state yet (the lazy-init contract)."""
        key = (name, cid)
        page = self._resident.get(key)
        if page is not None:
            self._resident.move_to_end(key)
            return page
        blob = self._spilled.pop(key, None)
        if blob is None:
            return None
        page = self._decode(name, blob)
        self._count("store.loads")
        self._admit(key, page)
        return page

    def _put(self, name: str, cid: int, value) -> None:
        self._admit((name, cid),
                    T.tree_map(lambda x: x.detach().clone(), value))

    def _drop(self, name: str, cid: int) -> None:
        key = (name, cid)
        page = self._resident.pop(key, None)
        if page is not None:
            self._resident_bytes -= page_nbytes(page)
        blob = self._spilled.pop(key, None)
        if page is None and blob is None:
            raise KeyError(cid)
        if isinstance(blob, str) and os.path.exists(blob):
            os.remove(blob)
        self._publish()

    def _admit(self, key: PageKey, page) -> None:
        """Insert or refresh a resident page, evicting LRU pages first
        until it fits, so resident bytes never pass the budget (provided
        one page fits it).  A write supersedes any spilled copy."""
        old_blob = self._spilled.pop(key, None)
        if isinstance(old_blob, str) and os.path.exists(old_blob):
            os.remove(old_blob)
        old = self._resident.pop(key, None)
        if old is not None:
            self._resident_bytes -= page_nbytes(old)
        need = page_nbytes(page)
        while self._resident and \
                self._resident_bytes + need > self.budget_bytes:
            self._evict_lru()
        self._resident[key] = page
        self._resident_bytes += need
        if self._resident_bytes > self._peak_resident_bytes:
            self._peak_resident_bytes = self._resident_bytes
        self._publish()

    def _evict_lru(self) -> None:
        key, page = self._resident.popitem(last=False)
        self._resident_bytes -= page_nbytes(page)
        self._spilled[key] = self._encode(key, page)
        self._count("store.spills")

    # --- spill serialisation ----------------------------------------------
    def _encode(self, key: PageKey, page):
        """Each leaf's bits on the host through zlib -> the blob tuple, or
        the spill file's path when spilling to disk."""
        blobs = tuple(zlib.compress(storage_view(leaf).tobytes(),
                                    COMPRESS_LEVEL)
                      for leaf in T.leaves(page))
        if self.spill_dir is None:
            return blobs
        path = os.path.join(self.spill_dir, f"{key[0]}_{key[1]}.page")
        with open(path, "wb") as f:
            for b in blobs:
                f.write(len(b).to_bytes(8, "little"))
                f.write(b)
        return path

    def _decode(self, name: str, blob):
        tmpl = self._ns_template(name)
        specs = self._specs[name]
        if isinstance(blob, str):
            blobs = []
            with open(blob, "rb") as f:
                for _ in specs:
                    n = int.from_bytes(f.read(8), "little")
                    blobs.append(f.read(n))
            os.remove(blob)
        else:
            blobs = blob
        leaves = []
        for b, (shape, dtype, device) in zip(blobs, specs):
            # a writable buffer: the page must own memory it may write
            raw = np.frombuffer(bytearray(zlib.decompress(b)),
                                dtype=storage_dtype(dtype)).reshape(shape)
            leaves.append(from_storage_view(raw, dtype, device))
        return _unflatten(tmpl, leaves)

    # --- telemetry ----------------------------------------------------------
    def _publish(self) -> None:
        if self.counters is None:
            return
        self.counters.set("store.resident_pages", len(self._resident))
        self.counters.set("store.resident_bytes", self._resident_bytes)
        self.counters.set("store.spilled_pages", len(self._spilled))

    def _count(self, name: str) -> None:
        if self.counters is not None:
            self.counters.inc(name)
