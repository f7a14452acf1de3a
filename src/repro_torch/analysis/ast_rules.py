"""Layer 1 of the port's analysis — AST checkers encoding the repo's
shipped bug classes, in torch idiom (counterpart of the JAX package's
``analysis/ast_rules.py``: the same six rule ids and the same runner).

Each rule is a pure function over one parsed module; the registry maps rule
ids to checkers.  Rules:

* ``truthiness-on-config`` — ``if cfg.x:`` / ``x or default`` where ``x``
  is a *numeric* field of the port's configs: 0 / 0.0 are valid values
  (``rounds=0``, ``buffer_k=0``, ``topk_frac=0.0``) and truthiness silently
  rewrites them.
* ``low-precision-accumulation`` — ``torch.sum``/``matmul``/``mm``/
  ``bmm``/``einsum``/``tensordot``/``index_add_`` consuming bf16/fp16/fp8
  operands with no ``.float()``, fp32 ``dtype=`` or fp32 accumulator in
  sight: bf16 sums lose late clients once ``Σw`` grows past the mantissa.
* ``unkeyed-config-cache`` — ``lru_cache`` on a function whose parameters
  are not all hashable scalars or frozen config dataclasses.
* ``host-sync-in-jit`` — here a host sync in a round body: ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()`` of a tensor, ``torch.cuda.synchronize`` or ``print`` inside
  the functions ``make_train_step`` and the ``_make_*`` factories return,
  or the engines' round methods (``ROUND_METHODS``).  Each stalls the
  card's queue, as a host read in a jit stalls a TPU's.
* ``timer-without-barrier`` — a ``time.time()``/``perf_counter()``
  interval in a benchmark module (``benchmarks/``, as in the reference)
  with no ``torch.cuda.synchronize``, ``block_until_ready``
  (``benchmarks.common``) or CUDA-event ``elapsed_time`` between start and
  stop: the clock stops before the card finishes.
* ``unbounded-host-accumulator`` — a ``self.x = [] / {}`` attribute that
  is appended to in engine loops and never reset/bounded.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

# --------------------------------------------------------------------------
# Repo context: config-field and frozen-config introspection
# --------------------------------------------------------------------------

# fallback sets, used only if the configs package cannot be imported (the
# live introspection below is the source of truth)
_FALLBACK_NUMERIC_FIELDS = frozenset({
    "rounds", "eval_every", "local_steps", "buffer_k", "head_dim",
    "sliding_window", "topk_frac", "qsgd_bits", "n_patch_tokens", "d_ff",
})
_FALLBACK_FROZEN_CONFIGS = frozenset({
    "ModelConfig", "FedConfig", "HeteroConfig", "ShapeConfig", "RunConfig",
    "MoEConfig", "MLAConfig", "SSMConfig", "SimConfig",
})

_SCALAR_ANNOTATIONS = {
    "int", "float", "str", "bool", "bytes", "None", "Optional",
    "Tuple", "tuple", "FrozenSet", "frozenset",
}


def _numeric_annotation(ann: str) -> bool:
    ann = ann.strip()
    return ann in ("int", "float", "Optional[int]", "Optional[float]")


@dataclasses.dataclass(frozen=True)
class RepoContext:
    """Facts about the repo the rules key on (field names, frozen configs)."""
    numeric_fields: frozenset
    frozen_configs: frozenset


def build_context() -> RepoContext:
    """Introspect the live config dataclasses for numeric field names and
    frozen (hashable, jit-static-safe) config class names."""
    numeric: Set[str] = set()
    frozen: Set[str] = set()
    try:
        import repro_torch.configs.base as cfgmod
        from repro_torch.federated.simulator import SimConfig
        candidates = [getattr(cfgmod, n) for n in dir(cfgmod)
                      if isinstance(getattr(cfgmod, n), type)]
        candidates.append(SimConfig)
        for cls in candidates:
            if not dataclasses.is_dataclass(cls):
                continue
            if getattr(cls, "__dataclass_params__").frozen:
                frozen.add(cls.__name__)
            for f in dataclasses.fields(cls):
                ann = f.type if isinstance(f.type, str) else getattr(
                    f.type, "__name__", str(f.type))
                if _numeric_annotation(str(ann)):
                    numeric.add(f.name)
    except Exception:
        return RepoContext(_FALLBACK_NUMERIC_FIELDS, _FALLBACK_FROZEN_CONFIGS)
    return RepoContext(frozenset(numeric), frozenset(frozen))


# --------------------------------------------------------------------------
# Shared AST plumbing
# --------------------------------------------------------------------------

class _Scoped(ast.NodeVisitor):
    """Visitor that tracks the enclosing Class.func dotted chain."""

    def __init__(self):
        self.stack: List[str] = []

    @property
    def context(self) -> str:
        return ".".join(self.stack)

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def _snippet(src_lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(src_lines):
        return src_lines[lineno - 1].strip()
    return ""


def _mk(rule: str, path: str, node: ast.AST, message: str, context: str,
        src_lines: List[str]) -> Finding:
    line = getattr(node, "lineno", 1)
    return Finding(rule=rule, path=path, line=line, message=message,
                   context=context, snippet=_snippet(src_lines, line))


def _attr_tokens(node: ast.AST) -> Set[str]:
    """All Name ids and Attribute attrs in a subtree."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for Attribute/Name chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# --------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------

RULES: Dict[str, Callable] = {}


def rule(rule_id: str):
    def deco(fn):
        RULES[rule_id] = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# truthiness-on-config
# --------------------------------------------------------------------------

@rule("truthiness-on-config")
def check_truthiness(tree: ast.Module, path: str, src_lines: List[str],
                     ctx: RepoContext) -> List[Finding]:
    fields = ctx.numeric_fields
    findings: List[Finding] = []

    class V(_Scoped):
        def _flag(self, expr, how):
            name = expr.attr if isinstance(expr, ast.Attribute) else expr.id
            findings.append(_mk(
                "truthiness-on-config", path, expr,
                f"truthiness on numeric config field {name!r} ({how}): "
                f"0/0.0 are valid values — compare explicitly "
                f"(`is None` / `> 0`)", self.context, src_lines))

        def _bool_ctx(self, expr):
            # `a or default` — only the tested (non-final) operands of an
            # `or`, every operand of an `and`, plain attr/name tests
            if isinstance(expr, ast.BoolOp):
                vals = expr.values
                tested = vals[:-1] if isinstance(expr.op, ast.Or) else vals
                for v in tested:
                    self._bool_ctx(v)
                return
            if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
                self._bool_ctx(expr.operand)
                return
            if isinstance(expr, ast.Attribute) and expr.attr in fields:
                self._flag(expr, "boolean test")
            elif isinstance(expr, ast.Name) and expr.id in fields:
                self._flag(expr, "boolean test")

        def visit_If(self, node):
            self._bool_ctx(node.test)
            self.generic_visit(node)

        def visit_While(self, node):
            self._bool_ctx(node.test)
            self.generic_visit(node)

        def visit_IfExp(self, node):
            self._bool_ctx(node.test)
            self.generic_visit(node)

        def visit_Assert(self, node):
            self._bool_ctx(node.test)
            self.generic_visit(node)

        def visit_comprehension(self, node):
            for if_ in node.ifs:
                self._bool_ctx(if_)
            self.generic_visit(node)

        def visit_BoolOp(self, node):
            # value-position `x or default` (assignments, call args, ...)
            if isinstance(node.op, ast.Or):
                for v in node.values[:-1]:
                    if isinstance(v, ast.Attribute) and v.attr in fields:
                        self._flag(v, "`or` default")
                    elif isinstance(v, ast.Name) and v.id in fields:
                        self._flag(v, "`or` default")
            self.generic_visit(node)

    V().visit(tree)
    return findings


# --------------------------------------------------------------------------
# low-precision-accumulation
# --------------------------------------------------------------------------

_LOW_TOKENS = {"bfloat16", "bf16", "float16", "half", "fp16",
               "float8_e4m3fn", "float8_e5m2", "fp8"}
# .float() / .double() casts, fp32 dtypes and fp32 accumulators
_SAFE_TOKENS = {"float32", "float64", "float", "double", "f32", "fp32",
                "promote_types", "result_type"}
_REDUCE_ATTRS = {"sum", "matmul", "mm", "bmm", "einsum", "tensordot",
                 "index_add_", "index_add", "cumsum", "addmm", "baddbmm",
                 "dot"}


@rule("low-precision-accumulation")
def check_low_precision(tree: ast.Module, path: str, src_lines: List[str],
                        ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []

    class V(_Scoped):
        def __init__(self):
            super().__init__()
            # one-level local-name resolution: x = <expr> lets the checker
            # see through `acc = torch.zeros(..., dtype=torch.float32)`
            # then `acc.index_add_(...)`
            self.local_tokens: Dict[str, Set[str]] = {}

        def visit_Assign(self, node):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.local_tokens[t.id] = _attr_tokens(node.value)
            self.generic_visit(node)

        def visit_Call(self, node):
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else (node.func.id if isinstance(node.func, ast.Name)
                      else "")
            # a bare ``sum(...)`` is Python's builtin, not a tensor sum
            builtin = isinstance(node.func, ast.Name) and attr == "sum"
            if attr in _REDUCE_ATTRS and not builtin:
                tokens = _attr_tokens(node)
                # resolve one level of local assignments
                for t in list(tokens):
                    tokens |= self.local_tokens.get(t, set())
                if tokens & _LOW_TOKENS and not tokens & _SAFE_TOKENS:
                    low = ", ".join(sorted(tokens & _LOW_TOKENS))
                    findings.append(_mk(
                        "low-precision-accumulation", path, node,
                        f"`{attr}` accumulates over {low} operands with no "
                        f".float() / fp32 dtype / fp32 accumulator — "
                        f"low-precision sums lose small contributions",
                        self.context, src_lines))
            self.generic_visit(node)

    V().visit(tree)
    return findings


# --------------------------------------------------------------------------
# unkeyed-config-cache
# --------------------------------------------------------------------------

_CONFIGISH = ("cfg", "config", "params", "tree", "state", "fed", "template")


def _is_cache_decorator(dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _dotted(target)
    return name.split(".")[-1] in ("lru_cache", "cache")


@rule("unkeyed-config-cache")
def check_unkeyed_cache(tree: ast.Module, path: str, src_lines: List[str],
                        ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    frozen = ctx.frozen_configs

    class V(_Scoped):
        def visit_FunctionDef(self, node):
            if any(_is_cache_decorator(d) for d in node.decorator_list):
                args = list(node.args.posonlyargs) + list(node.args.args) \
                    + list(node.args.kwonlyargs)
                for a in args:
                    if a.arg in ("self", "cls"):
                        continue
                    if a.annotation is not None:
                        tokens = _attr_tokens(a.annotation)
                        if tokens & frozen:
                            continue        # frozen config: a sound key
                        if tokens <= _SCALAR_ANNOTATIONS:
                            continue        # hashable scalar key
                        findings.append(_mk(
                            "unkeyed-config-cache", path, node,
                            f"lru_cache parameter {a.arg!r} annotated "
                            f"{ast.unparse(a.annotation)!r} is not a frozen "
                            f"config or hashable scalar — the cache key may "
                            f"not cover the wire-relevant fields",
                            self.context, src_lines))
                    elif a.arg.endswith(_CONFIGISH):
                        findings.append(_mk(
                            "unkeyed-config-cache", path, node,
                            f"lru_cache parameter {a.arg!r} is unannotated "
                            f"and config-like — key the cache on explicit "
                            f"frozen scalars",
                            self.context, src_lines))
            _Scoped.visit_FunctionDef(self, node)

    V().visit(tree)
    return findings


# --------------------------------------------------------------------------
# host-sync-in-jit
# --------------------------------------------------------------------------

# the engines' methods that run once a round (or once a dispatch group
# or flush of the semi-async engine)
ROUND_METHODS = {"run_round", "_round", "_client_half", "_server_half",
                 "_client_update", "_aggregate", "_dispatch", "_flush"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
# a float()/bool() of these reads a host value, not a tensor
_HOST_VALUE_TOKENS = {"shape", "numel", "size", "len", "dim", "ndim",
                      "element_size", "np", "numpy", "math", "statistics"}


def _is_maker(name: str) -> bool:
    return name == "make_train_step" or name.startswith("_make_")


def _returned_inner_defs(maker: ast.FunctionDef) -> List[ast.FunctionDef]:
    """Nested defs a factory returns (`def f(): ... ; return f`)."""
    inner = {n.name: n for n in maker.body
             if isinstance(n, ast.FunctionDef)}
    out = []
    for n in ast.walk(maker):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Name) \
                and n.value.id in inner:
            out.append(inner[n.value.id])
    return out


def round_bodies(tree: ast.Module) -> Set[ast.FunctionDef]:
    """The defs that run per round: what ``make_train_step`` and the
    ``_make_*`` factories return, the round methods of any class, the defs
    those bind from other factories, and every def nested in them."""
    makers: Dict[str, ast.FunctionDef] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.FunctionDef):
            makers[n.name] = n
    bodies: Set[ast.FunctionDef] = set()
    for fn in makers.values():
        if _is_maker(fn.name):
            bodies.update(_returned_inner_defs(fn))
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for fn in cls.body:
            if isinstance(fn, ast.FunctionDef) and fn.name in ROUND_METHODS:
                bodies.add(fn)

    # fixpoint over cross-factory closures: inside a factory whose inner
    # def runs per round, `f = _make_x()` binds f to _make_x's returned
    # def; if the round body calls f, that def runs per round too
    changed = True
    while changed:
        changed = False
        for maker in makers.values():
            inner = [d for d in maker.body
                     if isinstance(d, ast.FunctionDef) and d in bodies]
            if not inner:
                continue
            bindings: Dict[str, str] = {}
            for st in maker.body:
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name) \
                        and isinstance(st.value, ast.Call):
                    mname = _dotted(st.value.func).split(".")[-1]
                    if mname in makers:
                        bindings[st.targets[0].id] = mname
            for tfn in inner:
                for n in ast.walk(tfn):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Name) \
                            and n.func.id in bindings:
                        for d in _returned_inner_defs(
                                makers[bindings[n.func.id]]):
                            if d not in bodies:
                                bodies.add(d)
                                changed = True

    stack = list(bodies)
    while stack:
        fn = stack.pop()
        for n in ast.walk(fn):
            if isinstance(n, ast.FunctionDef) and n is not fn \
                    and n not in bodies:
                bodies.add(n)
                stack.append(n)
    return bodies


@rule("host-sync-in-jit")
def check_host_sync(tree: ast.Module, path: str, src_lines: List[str],
                    ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    for fn in sorted(round_bodies(tree), key=lambda f: f.lineno):
        # one-level local-name resolution: `stale = np.asarray(...)` makes
        # `float(stale.mean())` a host value
        local: Dict[str, Set[str]] = {}
        for n in _walk_own(fn):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        local[t.id] = _attr_tokens(n.value)
        # a nested def is a round body of its own
        for n in _walk_own(fn):
            if not isinstance(n, ast.Call):
                continue
            dn = _dotted(n.func)
            leaf = dn.split(".")[-1] if dn else (
                n.func.attr if isinstance(n.func, ast.Attribute) else "")
            bad = None
            arg = set()
            if n.args:
                arg = _attr_tokens(n.args[0])
                for t in list(arg):
                    arg |= local.get(t, set())
            if leaf in ("float", "bool") and dn == leaf and n.args \
                    and not isinstance(n.args[0], ast.Constant) \
                    and not arg & _HOST_VALUE_TOKENS:
                bad = f"{leaf}() of a tensor reads it back to the host"
            elif isinstance(n.func, ast.Attribute) \
                    and leaf in _SYNC_METHODS and not n.args:
                bad = f".{leaf}() reads the tensor back to the host"
            elif dn.endswith("cuda.synchronize"):
                bad = "torch.cuda.synchronize() waits for the card"
            elif dn == "print":
                bad = "print() inside a round body"
            if bad:
                findings.append(_mk(
                    "host-sync-in-jit", path, n,
                    f"{bad} in round body `{fn.name}` — it stalls the "
                    f"card's queue once a round",
                    fn.name, src_lines))
    return findings


# --------------------------------------------------------------------------
# timer-without-barrier (benchmarks/ only)
# --------------------------------------------------------------------------

_CLOCKS = {"time.time", "time.perf_counter", "time.monotonic"}
_BARRIER_TOKENS = ("synchronize", "block_until_ready", "elapsed_time",
                   "device_get")


def _is_benchmark(path: str) -> bool:
    return path.startswith("benchmarks/") or "/benchmarks/" in path


def _walk_own(fn: ast.AST):
    """The nodes of a def's body, nested defs and lambdas left out (each
    is checked as a function of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


@rule("timer-without-barrier")
def check_timer_barrier(tree: ast.Module, path: str, src_lines: List[str],
                        ctx: RepoContext) -> List[Finding]:
    if not _is_benchmark(path):
        return []
    findings: List[Finding] = []

    class V(_Scoped):
        def visit_FunctionDef(self, node):
            # every clock read bound to a name; an interval starts at the
            # last such binding before its stop
            starts: Dict[str, List[int]] = {}
            for n in _walk_own(node):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call) \
                        and _dotted(n.value.func) in _CLOCKS:
                    starts.setdefault(n.targets[0].id, []).append(n.lineno)
            for n in _walk_own(node):
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub) \
                        and isinstance(n.right, ast.Name) \
                        and n.right.id in starts \
                        and isinstance(n.left, ast.Call) \
                        and _dotted(n.left.func) in _CLOCKS:
                    stop = n.lineno
                    before = [ln for ln in starts[n.right.id] if ln <= stop]
                    if not before:
                        continue
                    start = max(before)
                    window = "\n".join(src_lines[start:stop])
                    if not any(t in window for t in _BARRIER_TOKENS):
                        findings.append(_mk(
                            "timer-without-barrier", path, n,
                            f"timed interval started at line {start} stops "
                            f"with no torch.cuda.synchronize/"
                            f"block_until_ready/elapsed_time between — "
                            f"the card's queue makes the measurement a "
                            f"lower bound", self.context, src_lines))
            _Scoped.visit_FunctionDef(self, node)

    V().visit(tree)
    return findings


# --------------------------------------------------------------------------
# unbounded-host-accumulator
# --------------------------------------------------------------------------

def _is_growable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    if name in ("list", "dict", "set", "OrderedDict",
                "collections.OrderedDict", "defaultdict",
                "collections.defaultdict"):
        return True
    if name in ("deque", "collections.deque"):
        # deque(maxlen=N) (or the two-positional form) is the bounded
        # structure this rule asks for — only an unbounded deque grows.
        # Fleet-package eviction/spill bookkeeping must be one of: a
        # maxlen deque, or page-table-bounded (popped on eviction/load).
        bounded = any(kw.arg == "maxlen" for kw in node.keywords) \
            or len(node.args) >= 2
        return not bounded
    return False


@rule("unbounded-host-accumulator")
def check_unbounded_accumulator(tree: ast.Module, path: str,
                                src_lines: List[str],
                                ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        inits: Dict[str, ast.AST] = {}        # attr -> first growable bind
        rebinds: Dict[str, int] = {}          # attr -> rebind count
        appends: Dict[str, ast.AST] = {}      # attr -> first append site
        clears: Set[str] = set()

        for n in ast.walk(cls):
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                value = n.value
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if value is not None and _is_growable_literal(value):
                            if t.attr in inits:
                                rebinds[t.attr] = rebinds.get(t.attr, 0) + 1
                            else:
                                inits[t.attr] = n
                        elif t.attr in inits:
                            rebinds[t.attr] = rebinds.get(t.attr, 0) + 1
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute):
                obj = n.func.value
                if isinstance(obj, ast.Attribute) \
                        and isinstance(obj.value, ast.Name) \
                        and obj.value.id == "self":
                    if n.func.attr in ("append", "extend", "insert",
                                       "setdefault", "update", "add",
                                       "appendleft"):
                        appends.setdefault(obj.attr, n)
                    elif n.func.attr in ("clear", "pop", "popleft",
                                         "popitem", "discard", "remove"):
                        clears.add(obj.attr)

        for attr, site in appends.items():
            if attr in inits and attr not in clears \
                    and rebinds.get(attr, 0) == 0:
                findings.append(_mk(
                    "unbounded-host-accumulator", path, site,
                    f"self.{attr} grows without reset/bound across the "
                    f"{cls.name} lifetime — use a bounded structure or "
                    f"reset per run (the staleness_seen class)",
                    cls.name, src_lines))
    return findings


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

TARGETS = ("src/repro_torch", "chip_smoke.py")


def run_ast_rules(root: str, targets: Tuple[str, ...] = TARGETS,
                  ctx: Optional[RepoContext] = None,
                  rules: Optional[Dict[str, Callable]] = None
                  ) -> List[Finding]:
    """Run every registered rule over the target trees and files (the
    port's package, its benchmarks among it, and ``chip_smoke.py``)."""
    import os

    ctx = build_context() if ctx is None else ctx
    rules = RULES if rules is None else rules
    findings: List[Finding] = []
    for target in targets:
        base = os.path.join(root, target)
        if os.path.isfile(base) and base.endswith(".py"):
            findings.extend(check_source_file(base, target, ctx, rules))
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                findings.extend(check_source_file(full, rel, ctx, rules))
    return findings


def check_source_file(full_path: str, rel_path: str,
                      ctx: Optional[RepoContext] = None,
                      rules: Optional[Dict[str, Callable]] = None
                      ) -> List[Finding]:
    ctx = build_context() if ctx is None else ctx
    rules = RULES if rules is None else rules
    with open(full_path) as f:
        src = f.read()
    return check_source(src, rel_path, ctx, rules)


def check_source(src: str, rel_path: str, ctx: Optional[RepoContext] = None,
                 rules: Optional[Dict[str, Callable]] = None
                 ) -> List[Finding]:
    """Run the rules over one source string (tests feed fixtures here)."""
    ctx = build_context() if ctx is None else ctx
    rules = RULES if rules is None else rules
    tree = ast.parse(src)
    src_lines = src.splitlines()
    findings: List[Finding] = []
    for checker in rules.values():
        findings.extend(checker(tree, rel_path, src_lines, ctx))
    return findings
