"""Roofline terms of a step counted on the ``meta`` device (counterpart of
the JAX package's ``launch/roofline.py``), with an H100's peaks.

Three terms per (arch × shape × mesh), in seconds per device:

  compute    = max(counted, model) FLOPs / bf16 dense peak
  memory     = bytes moved                / HBM rate
  collective = wire bytes                 / NVLink rate

The peaks are the spec sheet's for the card ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` names (``peaks_for``):

  H100 SXM5 (nvidia-smi "NVIDIA H100 80GB HBM3", 700 W): 989e12 bf16
      dense, 67e12 fp32 (CUDA cores), 3.35e12 B/s HBM3, 900e9 B/s NVLink;
  H100 NVL: 835e12, 60e12, 3.9e12, 600e9;
  H100 PCIe: 756e12, 51e12, 2.0e12, 600e9.

A card of another name (or none) takes the SXM5 figures, and says so in
``Peaks.name``.  No TPU figure is used.

The counts come from running the step on ``meta`` tensors (nothing is
computed or allocated) under two dispatch modes (``count``):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` — the matrix
  products (mm, bmm, addmm, convolutions, attention), 2 per multiply-add;
  elementwise work is not counted.  ``FlopCounter`` also sums them by
  their operands' dtype (``Counts.flops_by_dtype``): bf16 products run on
  the tensor cores, fp32 ones (TF32 off, PyTorch's default for matmul)
  on the CUDA cores, whose peaks differ fifteenfold, so a share of peak is
  taken per dtype (``Peaks.for_dtype``).
* bytes: ``ByteCounter``, the sum over every aten op of its input and
  output tensor bytes, views and aliases left out.  This is the unfused
  counterpart of XLA's ``bytes accessed``: each op reads its inputs from
  and writes its outputs to device memory, which a fused kernel would not,
  so it is an upper bound on what the step must move.

One card has no collectives: ``CollectiveStats`` keeps the reference's
fields with zero counts and ``collective_s`` is 0.  The reference's
``parse_collectives`` reads collectives out of XLA's optimised HLO text;
torch makes no such text, so it is not carried over.

``compute_s`` takes ``max(counted, model)`` as the reference does.  There
the max covers XLA counting a scan body once; torch runs no scan, so the
counted FLOPs come out at or above ``model_flops_per_round`` (remat
recomputes the forward, attention's quadratic term adds).
"""
from __future__ import annotations

import collections
import dataclasses
import subprocess
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    bf16_flops: float        # dense tensor-core bf16, FLOP/s
    fp32_flops: float        # CUDA cores, FLOP/s
    hbm_bw: float            # B/s
    link_bw: float           # NVLink, B/s


    def for_dtype(self, dtype: str) -> Optional[float]:
        """The peak FLOP/s of matrix products on ``dtype`` operands (a
        ``Counts.flops_by_dtype`` key), or None where none is given."""
        return {"bfloat16": self.bf16_flops, "float16": self.bf16_flops,
                "float32": self.fp32_flops}.get(dtype)


H100_SXM = Peaks("H100 SXM5 (spec sheet)", 989e12, 67e12, 3.35e12, 900e9)
H100_NVL = Peaks("H100 NVL (spec sheet)", 835e12, 60e12, 3.9e12, 600e9)
H100_PCIE = Peaks("H100 PCIe (spec sheet)", 756e12, 51e12, 2.0e12, 600e9)


def peaks_for(card_name: str) -> Peaks:
    """The spec-sheet peaks of the card ``card_name`` (nvidia-smi's or
    ``torch.cuda.get_device_name``)."""
    n = card_name.upper()
    if "H100" in n and "NVL" in n:
        return H100_NVL
    if "H100" in n and "PCIE" in n:
        return H100_PCIE
    if "H100" in n:
        return H100_SXM
    return dataclasses.replace(
        H100_SXM, name=f"H100 SXM5 (spec sheet; card {card_name!r} unknown)")


def card_name_and_power() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def card_peaks() -> Peaks:
    line = card_name_and_power()
    return peaks_for(line.split(",")[0]) if line else H100_SXM


# ---------------------------------------------------------------------------
# counting on the meta device
# ---------------------------------------------------------------------------
# ops that move no data although their schema is not a view's
_NO_DATA = {"aten._unsafe_view.default", "aten.lift_fresh.default",
            "aten.empty.memory_format", "aten.empty_strided.default",
            "aten.empty_like.default", "aten.new_empty.default",
            "aten.new_empty_strided.default", "aten.set_.source_Storage",
            "aten.resize_.default", "aten.sym_size.int",
            "aten.sym_stride.int", "aten.sym_numel.default"}


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's input and output tensor bytes (views and
    allocations without a write left out) into ``self.bytes``, and counts
    the ops by name in ``self.ops``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        self.ops[name] = self.ops.get(name, 0) + 1
        if not (func.is_view or name in _NO_DATA):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def _operand_dtype(args) -> str:
    """The float dtype(s) of a matrix product's tensor operands, as
    ``bfloat16`` or, where they mix, ``bfloat16+float32``."""
    leaves, _ = tree_flatten(args)
    names = sorted({str(t.dtype).replace("torch.", "") for t in leaves
                    if isinstance(t, torch.Tensor)
                    and t.dtype.is_floating_point})
    return "+".join(names) or "none"


class FlopCounter(FlopCounterMode):
    """``FlopCounterMode`` whose FLOPs are also summed by their operands'
    dtype into ``by_dtype``."""

    def __init__(self):
        super().__init__(display=False)
        self.by_dtype: Dict[str, int] = collections.Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            self.by_dtype[_operand_dtype(args)] += self.flop_registry[
                func_packet](*args, **kwargs, out_val=out)
        return super()._count_flops(func_packet, out, args, kwargs)


def _combine(x: Dict, y: Dict, a: float, b: float) -> Dict:
    """a·x + b·y key by key, zeros dropped."""
    out = {n: a * x.get(n, 0) + b * y.get(n, 0) for n in set(x) | set(y)}
    return {n: c for n, c in out.items() if c}


@dataclasses.dataclass
class Counts:
    flops: float = 0.0
    bytes: float = 0.0
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def combine(self, other: "Counts", a: float = 1.0, b: float = 1.0):
        """a·self + b·other, op by op and dtype by dtype."""
        return Counts(a * self.flops + b * other.flops,
                      a * self.bytes + b * other.bytes,
                      _combine(self.ops, other.ops, a, b),
                      _combine(self.flops_by_dtype, other.flops_by_dtype,
                               a, b))


def count(fn: Callable, *args, **kwargs):
    """Run ``fn`` under the FLOP and byte counters -> (its result,
    Counts).  Meant for ``meta`` tensors: nothing is computed."""
    bc = ByteCounter()
    with FlopCounter() as fc, bc:
        out = fn(*args, **kwargs)
    total = fc.get_total_flops()
    if sum(fc.by_dtype.values()) != total:
        raise RuntimeError(f"FLOPs by dtype {dict(fc.by_dtype)} do not sum "
                           f"to the counted {total}")
    return out, Counts(float(total), float(bc.bytes), dict(bc.ops),
                       {k: float(v) for k, v in fc.by_dtype.items() if v})


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]
    wire_bytes: float

    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())


def no_collectives() -> CollectiveStats:
    """One card's collectives: none."""
    return CollectiveStats({c: 0 for c in _COLLECTIVES},
                           {c: 0 for c in _COLLECTIVES}, 0.0)


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    wire_bytes: float
    chips: int
    collectives: CollectiveStats
    per_device_hbm: float          # the step's arguments' bytes a device
    model_flops_per_chip: float = 0.0
    peaks: Peaks = H100_SXM
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def compute_s(self):
        return max(self.flops, self.model_flops_per_chip) \
            / self.peaks.bf16_flops

    @property
    def compute_s_hlo(self):
        """The counted FLOPs alone (the reference's HLO count)."""
        return self.flops / self.peaks.bf16_flops

    @property
    def memory_s(self):
        return self.bytes_accessed / self.peaks.hbm_bw

    @property
    def collective_s(self):
        return self.wire_bytes / self.peaks.link_bw

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self):
        return {
            "flops": self.flops, "flops_by_dtype": self.flops_by_dtype,
            "bytes": self.bytes_accessed,
            "wire_bytes": self.wire_bytes,
            "compute_s": self.compute_s,
            "compute_s_hlo": self.compute_s_hlo,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "per_device_hbm_gb": self.per_device_hbm / 2**30,
            "collective_counts": self.collectives.counts,
            "peaks": self.peaks.name,
        }


def analyze(counts: Counts, mesh, model_flops_per_chip: float = 0.0,
            per_device_hbm: float = 0.0, peaks: Peaks = H100_SXM
            ) -> Roofline:
    """counts: the whole step's, run on one device; on a mesh of several
    devices each takes an even share."""
    chips = mesh.size
    return Roofline(flops=counts.flops / chips,
                    bytes_accessed=counts.bytes / chips, wire_bytes=0.0,
                    chips=chips, collectives=no_collectives(),
                    per_device_hbm=per_device_hbm,
                    model_flops_per_chip=model_flops_per_chip, peaks=peaks,
                    flops_by_dtype={k: v / chips for k, v in
                                    counts.flops_by_dtype.items()})


def model_flops_per_round(mcfg, shape, fed=None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens
    processed per step (per round for training: 3× for fwd+bwd is already
    the 6 factor; decode processes global_batch tokens)."""
    n = mcfg.active_param_count() if mcfg.moe is not None \
        else mcfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        f = 6.0 * n * tokens
        if fed is not None and fed.distill:
            f *= 4.0 / 3.0               # extra teacher forward
        return f
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
