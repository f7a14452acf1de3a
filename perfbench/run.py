"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is the result (JSON); the numbers
compared with the plain reference, each beside its limit, are the last
lines of standard error.  Without a CUDA card, with too few, or with
``jax``, ``jaxlib``, ``flax`` or the JAX package loaded once the window
has closed, it prints no result and exits non-zero.

The kernels' build directory is the program's own, inside the checkout
(``src/repro_torch/csrc/build``); Triton's and PyTorch's extension caches
are pointed at ``.bench_cache/`` in the checkout, so only a checkout's
first run builds.  ``setup_s`` leaves the build's seconds out; they are
on standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                    # noqa: E402
import os                                          # noqa: E402
import sys                                         # noqa: E402
from pathlib import Path                           # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import bench, manifest
    cell = manifest.cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device is available; the benchmark "
              "measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    t_import = time.perf_counter() - T_START
    from repro_torch.kernels import build
    t_build = time.perf_counter()
    built = [r for r in build.build_all() if r["built"]]
    build_s = time.perf_counter() - t_build
    print(f"perfbench: torch imported and the card found at {t_import:.3f} "
          f"s; the kernels' build {build_s:.3f} s ({len(built)} sources "
          f"compiled), not counted in setup_s", file=sys.stderr)
    # set-up runs from the process's start with the build's seconds left
    # out: only a checkout's first run compiles, and it is recorded apart
    out = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START + build_s)
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: the process loaded {bad}; the port and the "
              f"benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    bench.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
