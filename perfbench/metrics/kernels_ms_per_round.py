"""``kernels_ms_per_round``: device milliseconds a round in the port's own
CUDA kernels (``src/repro_torch/csrc/*.cu`` through ``kernels/ops.py``),
recognised by the names of their ``__global__`` functions below, over the
traced rounds."""

# the __global__ functions of src/repro_torch/csrc/*.cu
PATTERNS = (
    "axpy_leaves_kernel", "local_update_leaves_kernel",
    "server_update_leaves_kernel", "reduce_leaves_kernel",
    "qsgd_amax_kernel", "qsgd_leaves_kernel", "select_leaves_kernel",
    "sparse_count_kernel", "sparse_scan_kernel", "sparse_round_sums_kernel",
    "sparse_scan_rounds_kernel", "sparse_scatter_kernel",
    "sparse_apply_kernel", "kd_fwd_warp_kernel", "kd_fwd_cluster_kernel",
    "kd_split_lse_kernel", "kd_split_terms_kernel", "kd_split_finish_kernel",
    "kd_bwd_kernel", "flash_f32", "flash_bf16", "flash_wide", "ssd_sums",
    "ssd_carry", "ssd_states", "ssd_outputs",
)


def is_port(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(e - b for n, b, e in ctx.trace.events if is_port(n))
    return s * 1e3 / ctx.trace.rounds
