"""``kernels_roofline``: the port's sweep kernels against their roofline,
in %: the least time the card could take for their work (for each sweep
the larger of its bytes at the peak bandwidth and its operations at the
fp32 peak; ``yardstick/kernel_bytes.py``), over the device time all the
port's kernels took in the traced rounds.  A kernel of the port that no
listed sweep accounts for adds its time and no bound.  Nothing where the
engine lists no sweeps for the cell's strategy and wire, or no kernel of
the port ran."""
from perfbench.yardstick.kernel_bytes import family_of


def read(ctx):
    sweeps = ctx.engine.sweeps()
    if ctx.trace is None or sweeps is None:
        return None
    port = ctx.metric_module("kernels_ms_per_round").is_port
    measured = sum(e - b for n, b, e in ctx.trace.events if port(n))
    seen = {family_of(n) for n, _, _ in ctx.trace.events if port(n)}
    if measured <= 0:
        return None
    p = ctx.peaks
    bound = sum(sw["count"] * max(sw["bytes"] / p.hbm, sw["flops"] / p.fp32)
                for sw in sweeps if sw["family"] in seen)
    return 100.0 * bound * ctx.trace.rounds / measured
