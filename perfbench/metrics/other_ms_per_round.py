"""``other_ms_per_round``: device milliseconds a round in every operation
that is neither a matrix product nor one of the port's own kernels: the
model's elementwise glue, copies, casts, reductions, library kernels.
Over the traced rounds."""
from perfbench.yardstick.gemm_words import gemm_class


def read(ctx):
    if ctx.trace is None:
        return None
    port = ctx.metric_module("kernels_ms_per_round").is_port
    s = sum(e - b for n, b, e in ctx.trace.events
            if not port(n) and gemm_class(n) is None)
    return s * 1e3 / ctx.trace.rounds
