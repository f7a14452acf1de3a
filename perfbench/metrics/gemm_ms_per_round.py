"""``gemm_ms_per_round``: device milliseconds a round in matrix products
(cuBLAS, cuBLASLt, CUTLASS, cuDNN's implicit-GEMM convolutions: the
frozen ``GEMM_WORDS``), the port's own kernels left out, over the traced
rounds."""
from perfbench.yardstick.gemm_words import gemm_class


def read(ctx):
    if ctx.trace is None:
        return None
    port = ctx.metric_module("kernels_ms_per_round").is_port
    s = sum(e - b for n, b, e in ctx.trace.events
            if not port(n) and gemm_class(n) is not None)
    return s * 1e3 / ctx.trace.rounds
