"""Layer 2 of the port's analysis — run-time audits at tiny synthetic sizes
(counterpart of the JAX package's ``analysis/trace_audit.py``; shaped
zeros, no real data).

The reference walks jaxprs; torch has none, so each audit runs the code
under a ``TorchDispatchMode`` that sees every aten op.  Three audits, each
returning ``Finding``s on the same envelope as the AST rules:

* **per-round cost** (``trace-retrace``) — build each round engine of
  ``RETRACE_MATRIX`` (the reference's, plus the pod engine's default), run
  a warm-up round and then two identically shaped rounds, and require that
  round 2 makes the same aten-op multiset as round 1, allocations
  included (for the semi-async engine: its flushes, and its dispatch
  groups of one size, each after its first).  A round
  that grows (a cache keyed on the wrong thing, a tensor re-made each
  round) is the torch form of a retrace.  On the card the rounds must
  also launch each kernel of ``ops.KERNELS`` as often, and load no kernel
  library again (``kernels/build.py``).
* **accumulation dtype** (``trace-accumulation-dtype``) — the weighted
  reductions (``ref`` and ``ops``) on a bf16 stack, the sparse reduce on a
  bf16 wire, the pod engine's client accumulation under the mixed
  ``RunConfig`` and the FedADC momentum update with bf16 parameters: a
  reduction whose float inputs include one below fp32 and whose float
  outputs are all below fp32 is flagged, as is an in-place accumulation
  (``add_``, ``index_add_``, ``index_put_`` with accumulate) into a
  destination below fp32, and momentum held below fp32.  The pod round is
  held to the second check only: its local steps run bf16 products by
  design, and its Σ w·Δ must land in fp32.
* **kernel coverage** (``trace-kernel-coverage``) — every entry of
  ``repro_torch.kernels.ops.KERNELS`` needs a plain version in
  ``kernels/ref.py``, a parity test in some ``tests/test_torch_*.py`` and
  a check in ``chip_smoke.py`` (which calls its wrapper by name).
"""
from __future__ import annotations

import ast
import collections
import glob
import os
import traceback
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding

_LOW_FLOATS = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
               torch.float8_e5m2)
# aten ops that accumulate across elements
_REDUCE_OPS = {"sum", "mean", "mm", "bmm", "addmm", "baddbmm", "dot", "mv",
               "matmul", "cumsum", "index_add", "scatter_add",
               "segment_reduce", "_index_put_impl"}
# in-place accumulations: the destination is the first operand
_ACCUMULATE_OPS = {"add_", "index_add_", "index_put_", "_index_put_impl_",
                   "scatter_add_"}


def _op_name(func) -> str:
    """``aten.index_add_.default`` -> ``index_add_``."""
    return str(func).split(".")[1]


def _floats(tree):
    leaves, _ = tree_flatten(tree)
    return [t.dtype for t in leaves
            if isinstance(t, torch.Tensor) and t.dtype.is_floating_point]


def _accumulates(name, args, kwargs) -> bool:
    if name not in _ACCUMULATE_OPS:
        return False
    if name in ("index_put_", "_index_put_impl_"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc)
    return True


class AccumulationAudit(TorchDispatchMode):
    """Records each reduction that accumulates below fp32 and each in-place
    accumulation into a destination below fp32 into ``violations``, a list
    the caller owns."""

    def __init__(self, where: str, violations: List[str],
                 reductions: bool = True):
        super().__init__()
        self.where = where
        self.reductions = reductions
        self.violations = violations

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _op_name(func)
        if _accumulates(name, args, kwargs) \
                and isinstance(args[0], torch.Tensor) \
                and args[0].dtype in _LOW_FLOATS:
            self.violations.append(
                f"{self.where}: `{name}` accumulates into a "
                f"{args[0].dtype} destination")
        elif self.reductions and name.rstrip("_") in _REDUCE_OPS:
            ins, outs = _floats((args, kwargs)), _floats(out)
            if ins and outs and any(d in _LOW_FLOATS for d in ins) \
                    and all(d in _LOW_FLOATS for d in outs):
                self.violations.append(
                    f"{self.where}: `{name}` accumulates in {outs[0]} "
                    f"(inputs {[str(d) for d in ins]})")
        return out


_ALLOCATIONS = ("aten.empty", "aten.empty_strided", "aten.empty_like",
                "aten.new_empty")


def _site() -> str:
    """The innermost frame of the port's code on the stack, as
    ``file:line``."""
    for frame in reversed(traceback.extract_stack()[:-2]):
        if "repro_torch" in frame.filename:
            return (f"{frame.filename.rsplit('repro_torch', 1)[1][1:]}:"
                    f"{frame.lineno}")
    return "?"


class OpRecorder(TorchDispatchMode):
    """The multiset of aten ops run under it (``self.ops``), allocations
    included, and where in the port each allocation was made
    (``self.sites``, (op, ``file:line``) -> count), so that a round that
    allocates once more says where."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.sites: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops[name] += 1
        if name.startswith(_ALLOCATIONS):
            self.sites[(name, _site())] += 1
        return func(*args, **(kwargs or {}))


# --------------------------------------------------------------------------
# findings plumbing + tiny synthetic fixtures
# --------------------------------------------------------------------------

def _finding(rule: str, path: str, message: str, context: str) -> Finding:
    return Finding(rule=rule, path=path, line=1, message=message,
                   context=context, snippet=f"<trace:{context}>")


_IMG = 16          # must survive the CNN's 4 pools (image_size // 16 >= 1)
_NCLASS = 4


def _synthetic_dataset(n: int = 48):
    x = np.zeros((n, _IMG, _IMG, 3), np.float32)
    y = (np.arange(n) % _NCLASS).astype(np.int32)
    return x, y


def _partitions(n: int, n_clients: int) -> List[np.ndarray]:
    return [np.arange(i, n, n_clients) for i in range(n_clients)]


def _sim_config():
    from repro_torch.federated.simulator import SimConfig
    return SimConfig(rounds=2, n_classes=_NCLASS, batch_size=4,
                     eval_every=100, eval_batch=8, cnn_width=4, seed=0)


def _build_sync(fed_kwargs: Dict, device):
    from repro_torch.configs.base import FedConfig
    from repro_torch.federated.simulator import FederatedSimulator

    fed = FedConfig(strategy="fedadc", local_steps=2, clients_per_round=4,
                    n_clients=8, **fed_kwargs)
    x, y = _synthetic_dataset()
    return FederatedSimulator(fed, _sim_config(), x, y, x[:8], y[:8],
                              _partitions(len(x), fed.n_clients),
                              device=device)


def _build_async(fed_kwargs: Dict, device):
    from repro_torch.configs.base import FedConfig, HeteroConfig
    from repro_torch.federated.async_engine import AsyncFederatedSimulator

    fed = FedConfig(strategy="fedadc", local_steps=2, clients_per_round=4,
                    n_clients=8, buffer_k=2, **fed_kwargs)
    hetero = HeteroConfig(enabled=True, speed_dist="uniform",
                          speed_range=(0.5, 1.0), seed=0)
    x, y = _synthetic_dataset()
    return AsyncFederatedSimulator(fed, _sim_config(), hetero, x, y,
                                   x[:8], y[:8],
                                   _partitions(len(x), fed.n_clients),
                                   device=device)


def _pod_configs():
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import FedConfig, RunConfig

    mcfg = ARCHS["qwen3-4b"].reduced()
    fed = FedConfig(strategy="fedadc", clients_per_round=2, local_steps=2,
                    eta=0.05)
    run = RunConfig(remat="none", param_dtype="float32",
                    compute_dtype="bfloat16")
    return mcfg, fed, run


def _pod_batch(device):
    toks = torch.zeros((1, 2, 2, 2, 32), dtype=torch.int32, device=device)
    return {"tokens": toks, "labels": toks}


# --------------------------------------------------------------------------
# audit: accumulation dtype
# --------------------------------------------------------------------------

def _audited(where, path, fn, reductions=True) -> List[Finding]:
    violations: List[str] = []
    with AccumulationAudit(where, violations, reductions):
        fn()
    return [_finding("trace-accumulation-dtype", path, v, where)
            for v in violations]


def audit_accumulation_dtype() -> List[Finding]:
    """On the CPU: the plain versions are what accumulates there."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import tree as T
    from repro_torch.core.strategies import get_strategy
    from repro_torch.kernels import ops, ref

    device = torch.device("cpu")
    findings: List[Finding] = []
    K, D = 8, 16
    gen = torch.Generator().manual_seed(0)
    deltas = torch.randn((K, D), generator=gen).to(device, torch.bfloat16)
    weights = torch.rand((K,), generator=gen).to(device)

    # 1. the weighted reduction: plain version and wrapper on a bf16 stack
    findings += _audited("ref.weighted_delta_reduce",
                         "src/repro_torch/kernels/ref.py",
                         lambda: ref.weighted_delta_reduce(deltas, weights))
    findings += _audited("ops.weighted_delta_reduce_tree",
                         "src/repro_torch/kernels/ops.py",
                         lambda: ops.weighted_delta_reduce_tree(
                             {"w": deltas}, weights))

    # 1b. the sparse reduce on a bf16 wire, into a bf16 leaf: the adds must
    # land in fp32 even when the cast-on-write target is bf16
    kk = 8
    svals = torch.randn((K, kk), generator=gen).to(device, torch.bfloat16)
    sidx = torch.stack([torch.randperm(D, generator=gen)[:kk]
                        for _ in range(K)]).to(device, torch.int32)
    findings += _audited("ref.sparse_weighted_delta_reduce",
                         "src/repro_torch/kernels/ref.py",
                         lambda: ref.sparse_weighted_delta_reduce(
                             svals, sidx, weights, (D,), torch.bfloat16))
    findings += _audited("ops.sparse_weighted_delta_reduce_tree",
                         "src/repro_torch/kernels/ops.py",
                         lambda: ops.sparse_weighted_delta_reduce_tree(
                             {"w": svals}, {"w": sidx}, weights,
                             {"w": torch.empty((D,), dtype=torch.bfloat16,
                                               device=device)}))

    # 2. the FedADC momentum recursion with fp32 and bf16 parameters: the
    # momentum must come back fp32 (a bf16 m sums Δ̄ across rounds in
    # bf16), no reduction inside may accumulate low, θ keeps its dtype
    fed = FedConfig(strategy="fedadc")
    strat = get_strategy(fed.strategy)
    for regime, pdt in (("fp32-params", torch.float32),
                        ("bf16-params", torch.bfloat16)):
        params = {"w": torch.randn((16,), generator=gen).to(device, pdt)}
        mean_delta = {"w": torch.randn((16,), generator=gen).to(device, pdt)}
        server_state = strat.server_init(params)
        ctxname = f"fedadc.server_update[{regime}]"
        out = {}
        findings += _audited(ctxname, "src/repro_torch/core/strategies.py",
                             lambda: out.update(zip(("theta", "ss"),
                                                    strat.server_update(
                                 server_state, params, mean_delta, fed))))
        for leaf in T.leaves(out["ss"]):
            if leaf.dtype in _LOW_FLOATS:
                findings.append(_finding(
                    "trace-accumulation-dtype",
                    "src/repro_torch/core/strategies.py",
                    f"{ctxname}: server momentum leaf carried in "
                    f"{leaf.dtype} — cross-round accumulation below fp32",
                    ctxname))
        for leaf in T.leaves(out["theta"]):
            if leaf.dtype != pdt:
                findings.append(_finding(
                    "trace-accumulation-dtype",
                    "src/repro_torch/core/strategies.py",
                    f"{ctxname}: θ update changed the parameter dtype to "
                    f"{leaf.dtype} (expected {pdt})", ctxname))

    # 3. the pod engine's client accumulation under the mixed round
    findings.extend(_audit_pod_accumulation(device))
    return findings


def _audit_pod_accumulation(device) -> List[Finding]:
    from repro_torch.launch.train import init_state, make_train_step

    mcfg, fed, run = _pod_configs()
    try:
        state = init_state(0, mcfg, fed, run, device=device)
        step = make_train_step(mcfg, fed, run)
        batch = _pod_batch(device)
    except Exception as e:                       # pragma: no cover
        return [_finding("trace-accumulation-dtype",
                         "src/repro_torch/launch/train.py",
                         f"pod engine audit could not run: {e!r}",
                         "pod.train_step")]
    return _audited("pod.train_step", "src/repro_torch/launch/train.py",
                    lambda: step(state, batch), reductions=False)


# --------------------------------------------------------------------------
# audit: per-round cost
# --------------------------------------------------------------------------

# The reference's engine round matrix: the uplink codec families × the
# downlink codec families that take distinct paths.
RETRACE_MATRIX = (
    ("sync", {}),
    ("sync", {"compressor": "topk", "topk_frac": 0.5,
              "error_feedback": True}),
    ("sync", {"compressor": "topk", "topk_frac": 0.5,
              "error_feedback": True, "sparse_uplink": True}),
    ("sync", {"downlink_compressor": "delta"}),
    ("sync", {"downlink_compressor": "delta+qsgd", "downlink_qsgd_bits": 8}),
    ("async", {}),
    ("async", {"downlink_compressor": "delta", "compressor": "qsgd",
               "qsgd_bits": 4}),
)


class _Rounds:
    """Each call of a round function recorded into ``records`` (a list the
    caller owns): its key, aten-op multiset, kernel launches (on the card),
    the kernel libraries loaded after it and its allocations' sites."""

    def __init__(self, records: List[tuple], key=None):
        self.records = records
        self.key = key

    def wrap(self, fn):
        def recorded(*args, **kwargs):
            from repro_torch.kernels import build, ops
            before = ops.launch_counts()
            rec = OpRecorder()
            with rec:
                out = fn(*args, **kwargs)
            after = ops.launch_counts()
            launches = {n: after[n] - before[n] for n in after
                        if after[n] != before[n]}
            key = self.key(*args, **kwargs) if self.key else None
            self.records.append((key, rec.ops, launches,
                                 dict(build._LIBS), rec.sites))
            return out
        return recorded


def _compare(records, what, ctxname, path) -> List[Finding]:
    """Every record after the first warm-up one must equal the one before
    it among those with its key."""
    findings = []
    last = {}
    for i, (key, ops, launches, libs, sites) in enumerate(records):
        if key in last:
            j, (pops, plaunches, plibs, psites) = last[key]
            if ops != pops:
                diff = sorted(set(ops.items()) ^ set(pops.items()))[:6]
                where = sorted(set(sites.items()) ^ set(psites.items()))[:6]
                findings.append(_finding(
                    "trace-retrace", path,
                    f"{what} {i + 1} makes other aten ops than {what} "
                    f"{j + 1} ({ctxname}): {diff}"
                    + (f"; allocations at {where}" if where else ""),
                    ctxname))
            if launches != plaunches:
                findings.append(_finding(
                    "trace-retrace", path,
                    f"{what} {i + 1} launches {launches}, {what} {j + 1} "
                    f"{plaunches} ({ctxname})", ctxname))
            if any(libs.get(k) is not v for k, v in plibs.items()) \
                    or len(libs) != len(plibs):
                findings.append(_finding(
                    "trace-retrace", path,
                    f"{what} {i + 1} loaded a kernel library again "
                    f"({ctxname})", ctxname))
        last[key] = (i, (ops, launches, libs, sites))
    return findings


def _steady(records):
    """The records after each key's first (its warm-up)."""
    seen, out = set(), []
    for r in records:
        if r[0] in seen:
            out.append(r)
        seen.add(r[0])
    return out


def audit_retrace(matrix: Sequence = RETRACE_MATRIX, include_pod: bool = True,
                  device="cpu", seen=None) -> List[Finding]:
    """A warm-up round, then two identically shaped rounds per engine
    config: the second must make the first's aten ops (and launches).
    ``seen``, a list, gets (config, what, launches) of every round run."""
    findings: List[Finding] = []

    def note(ctxname, what, records):
        if seen is not None:
            seen.extend((ctxname, f"{what} {i + 1}", r[2])
                        for i, r in enumerate(records))
    for engine, fed_kwargs in matrix:
        kv = ",".join(f"{k}={v}" for k, v in sorted(fed_kwargs.items()))
        ctxname = f"{engine}:{kv or 'default'}"
        try:
            if engine == "sync":
                s = _build_sync(fed_kwargs, device)
                records: List[tuple] = []
                run_round = _Rounds(records).wrap(s.run_round)
                for _ in range(3):
                    run_round(*s.next_round_inputs())
                findings += _compare(_steady(records), "round", ctxname,
                                     "src/repro_torch/federated/simulator.py")
                note(ctxname, "round", records)
            else:
                s = _build_async(fed_kwargs, device)
                flushes: List[tuple] = []
                groups: List[tuple] = []
                # instruments on this engine object only
                s._flush = _Rounds(flushes).wrap(s._flush)
                s._dispatch = _Rounds(
                    groups, key=lambda heap, n, now: n).wrap(s._dispatch)
                # the first dispatch group is the in-flight wave (its own
                # size); six flushes leave four steady groups of K
                s.run(rounds=6)
                path = "src/repro_torch/federated/async_engine.py"
                findings += _compare(_steady(flushes), "flush", ctxname,
                                     path)
                findings += _compare(_steady(groups), "dispatch group",
                                     ctxname, path)
                note(ctxname, "flush", flushes)
                note(ctxname, "dispatch group", groups)
        except Exception as e:
            findings.append(_finding(
                "trace-retrace", "src/repro_torch/analysis/trace_audit.py",
                f"engine {ctxname} failed to run: {e!r}", ctxname))
    if include_pod:
        findings.extend(_audit_pod_retrace(device))
    return findings


def _audit_pod_retrace(device) -> List[Finding]:
    from repro_torch.launch.train import init_state, make_train_step

    mcfg, fed, run = _pod_configs()
    try:
        state = init_state(0, mcfg, fed, run, device=device)
        records: List[tuple] = []
        step = _Rounds(records).wrap(make_train_step(mcfg, fed, run))
        batch = _pod_batch(device)
        for _ in range(3):
            state, _ = step(state, batch)
    except Exception as e:
        return [_finding("trace-retrace", "src/repro_torch/launch/train.py",
                         f"pod per-round audit could not run: {e!r}",
                         "pod:default")]
    return _compare(_steady(records), "round", "pod:default",
                    "src/repro_torch/launch/train.py")


# --------------------------------------------------------------------------
# audit: kernel coverage
# --------------------------------------------------------------------------

# ops.KERNELS name -> its plain version's name in ref.py where they differ
KERNEL_ORACLE_ALIASES = {
    "local_update": "fedadc_local_update",
    "server_update": "fedadc_server_update",
    "weighted_reduce": "weighted_delta_reduce",
    "threshold_select": "topk_threshold_select",
    "qsgd": "qsgd_quantize",
    "sparse_reduce": "sparse_weighted_delta_reduce",
}


def kernel_table(ops_path: str) -> Dict[str, str]:
    """``KERNELS`` of ``kernels/ops.py``, read from its source: name -> the
    launching wrapper's function name."""
    with open(ops_path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "KERNELS"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                wrapper = v.attr if isinstance(v, ast.Attribute) else (
                    v.id if isinstance(v, ast.Name) else "")
                out[k.value] = wrapper
            return out
    return {}


def audit_kernel_coverage(root: str) -> List[Finding]:
    findings: List[Finding] = []
    kdir = os.path.join(root, "src/repro_torch/kernels")
    ops_path = os.path.join(kdir, "ops.py")
    ref_path = os.path.join(kdir, "ref.py")
    if not (os.path.exists(ops_path) and os.path.exists(ref_path)):
        return [_finding("trace-kernel-coverage",
                         "src/repro_torch/kernels/ops.py",
                         "kernels/ops.py or kernels/ref.py missing",
                         "kernel-coverage")]
    with open(ref_path) as f:
        ref_names = {n.name for n in ast.parse(f.read()).body
                     if isinstance(n, ast.FunctionDef)}
    tests = ""
    for p in sorted(glob.glob(os.path.join(root, "tests",
                                           "test_torch_*.py"))):
        with open(p) as f:
            tests += f.read()
    smoke = ""
    if os.path.exists(os.path.join(root, "chip_smoke.py")):
        with open(os.path.join(root, "chip_smoke.py")) as f:
            smoke = f.read()
    table = kernel_table(ops_path)
    if not table:
        findings.append(_finding("trace-kernel-coverage",
                                 "src/repro_torch/kernels/ops.py",
                                 "kernels/ops.py defines no KERNELS table",
                                 "kernel-coverage"))
    for name, wrapper in sorted(table.items()):
        oracle = KERNEL_ORACLE_ALIASES.get(name, name)
        if oracle not in ref_names:
            findings.append(_finding(
                "trace-kernel-coverage", "src/repro_torch/kernels/ref.py",
                f"kernel {name} has no plain version in kernels/ref.py "
                f"(expected `{oracle}`)", name))
        if f"ref.{oracle}" not in tests and wrapper not in tests:
            findings.append(_finding(
                "trace-kernel-coverage", "tests/",
                f"kernel {name} has no parity test in tests/test_torch_*.py "
                f"(neither `ref.{oracle}` nor `{wrapper}` appears)", name))
        if f"{wrapper}(" not in smoke:
            findings.append(_finding(
                "trace-kernel-coverage", "chip_smoke.py",
                f"kernel {name} has no check in chip_smoke.py (its wrapper "
                f"`{wrapper}` is never called)", name))
    return findings


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def run_trace_audits(root: str, include_retrace: bool = True
                     ) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(audit_kernel_coverage(root))
    findings.extend(audit_accumulation_dtype())
    if include_retrace:
        findings.extend(audit_retrace())
    return findings
