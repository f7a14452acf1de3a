"""Serving latency summarisation (a copy of the JAX package's
``telemetry/latency.py``).

``RequestOutput`` carries raw timestamps (arrival, first token, finish);
this is the one place they are turned into the serving headline numbers —
TTFT, ITL (mean inter-token gap, ``(finish − first_token)/(n_tokens − 1)``,
undefined for single-token requests), and end-to-end latency, each as
p50/p95/mean percentiles over a request set.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence


def _percentiles(values: Sequence[float]) -> Dict[str, float]:
    s = sorted(values)
    n = len(s)

    def pct(q: float) -> float:
        # nearest-rank on the sorted sample; exact at the edges, no numpy
        # dependency so the helper also runs host-only
        return s[min(n - 1, int(q * n))]

    return {"p50": round(pct(0.50), 6), "p95": round(pct(0.95), 6),
            "mean": round(sum(s) / n, 6)}


def request_itl(output) -> Optional[float]:
    """Mean inter-token latency of one request; None when only one token
    was generated (no gap exists)."""
    n = len(output.tokens)
    if n < 2:
        return None
    return (output.finish_t - output.first_token_t) / (n - 1)


def latency_summary(outputs) -> Dict[str, object]:
    """TTFT / ITL / e2e percentile summary over finished request outputs.

    Any object with ``arrival_t`` / ``first_token_t`` / ``finish_t`` /
    ``tokens`` works (``RequestOutput`` does).  Requests that generated a
    single token contribute to TTFT/e2e but not ITL; ``n_itl_requests``
    records how many did contribute.
    """
    outs = list(outputs)
    if not outs:
        raise ValueError("latency_summary needs at least one finished "
                         "request")
    ttfts = [o.first_token_t - o.arrival_t for o in outs]
    e2es = [o.finish_t - o.arrival_t for o in outs]
    itls = [itl for itl in (request_itl(o) for o in outs) if itl is not None]
    summary: Dict[str, object] = {
        "n_requests": len(outs),
        "n_tokens": sum(len(o.tokens) for o in outs),
        "ttft_s": _percentiles(ttfts),
        "e2e_s": _percentiles(e2es),
        "n_itl_requests": len(itls),
    }
    summary["itl_s"] = _percentiles(itls) if itls else None
    return summary
