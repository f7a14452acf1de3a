"""Paper Sec. II-A (communication load): FedADC's uplink equals FedAvg's;
the downlink additionally carries the momentum/model-difference broadcast
(2× naive, 1× when Δ̄-broadcast overlaps compute as the paper proposes).

Two accountings per architecture, side by side:

* **analytic** — the paper's own bytes/round table (n_params × dtype bytes
  × clients), per strategy.
* **measured** — what the transport layer actually puts on the wire, in
  BOTH directions, from the real parameter tree of the arch (an init on
  the ``meta`` device: shapes and dtypes, nothing allocated):

  - uplink: each compressor codec's exact wire format
    (``Transport.uplink_wire_nbytes``);
  - downlink: the {"params": θ_t, "ctx": ctx} broadcast tree the strategy
    really ships — FedADC's ctx carries m̄_t, so its measured naive
    downlink is 2× the parameter bytes *by construction of the wire tree*,
    not by analytic assumption — under the pluggable downlink codecs.

Every byte count is exact, so each row equals the reference's character
for character.
"""
import numpy as np

from repro_torch.benchmarks.common import emit
from repro_torch.configs import ARCHS
from repro_torch.configs.base import FedConfig
from repro_torch.core.strategies import get_strategy
from repro_torch.federated import compression as C
from repro_torch.federated.reference import ReferenceStore
from repro_torch.federated.transport import Transport
from repro_torch.models.registry import get_model


def bytes_per_round(n_params, clients, dtype_bytes=4):
    p = n_params * dtype_bytes
    return {
        # uplink: every selected client pushes Δ_i
        "fedavg":        {"up": clients * p, "down": clients * p},
        "slowmo":        {"up": clients * p, "down": clients * p},
        # naive FedADC: pull θ_t AND m_t
        "fedadc_naive":  {"up": clients * p, "down": clients * 2 * p},
        # overlapped (paper): S_{t+1} pre-receives (θ_t, m_t) during round t
        # compute; at t+1 only Δ̄_t is pulled on the critical path
        "fedadc_overlap": {"up": clients * p, "down": clients * p},
    }


def param_shapes(arch: str):
    """Parameter tree of the arch as ``meta`` tensors (no allocation)."""
    mcfg = ARCHS[arch]
    return get_model(mcfg).init(0, mcfg, device="meta")


def broadcast_template(strategy_name: str, shapes, fed: FedConfig):
    """The {"params": θ_t, "ctx": ctx} downlink wire tree as ``meta``
    tensors — ctx is what ``strategy.client_setup`` really broadcasts (m̄_t
    for FedADC, θ_t for FedProx, nothing for FedAvg)."""
    s = get_strategy(strategy_name)
    server = s.server_init(shapes)
    return {"params": shapes, "ctx": s.client_setup(server, shapes, fed)}


UPLINK = (
    ("raw", {}),
    ("topk10", {"compressor": "topk", "topk_frac": 0.10}),
    ("qsgd4", {"compressor": "qsgd", "qsgd_bits": 4}),
    ("qsgd8", {"compressor": "qsgd", "qsgd_bits": 8}),
)
DOWNLINK = (
    ("raw", {}),
    ("topk10", {"downlink_compressor": "topk", "downlink_topk_frac": 0.10}),
    ("qsgd8", {"downlink_compressor": "qsgd", "downlink_qsgd_bits": 8}),
    # momentum-aware reference-coded broadcast: steady-state bytes are the
    # θ-delta through the inner codec; a derivable ctx (FedADC's m̄) is 0
    ("delta", {"downlink_compressor": "delta"}),
    ("delta_topk10", {"downlink_compressor": "delta+topk",
                      "downlink_topk_frac": 0.10}),
    ("delta_qsgd8", {"downlink_compressor": "delta+qsgd",
                     "downlink_qsgd_bits": 8}),
)


def _unicast_totals(fed: FedConfig, tpl, schedule):
    """Accounting-only replay of a participation schedule through the
    unicast ReferenceStore (no training): round v dispatches schedule[v],
    each client classified fresh/catch-up/resync against its last version."""
    t = Transport(fed)
    t.set_wire_templates(tpl["params"], tpl)
    refs = ReferenceStore(fed, t)
    for v, clients in enumerate(schedule):
        refs.dispatch(clients, v)
    return t.downlink_bytes, int(refs.catchups), int(refs.resyncs)


def _multicast_totals(fed: FedConfig, tpl, schedule):
    t = Transport(fed)
    t.set_wire_templates(tpl["params"], tpl)
    for v, clients in enumerate(schedule):
        t.account_downlink(len(clients), resync=(v == 0))
    return t.downlink_bytes


def unicast_rows(rows, arch: str, shapes, rounds=12, n_clients=8):
    """Unicast vs multicast downlink bytes side by side, per (lossless
    delta) codec spelling: under full participation the per-client
    schedule degenerates to the multicast one byte-for-byte; under
    intermittent participation the catch-up horizon is what separates
    cheap chained deltas from full-θ resyncs."""
    full = [list(range(n_clients))] * rounds
    rng = np.random.RandomState(0)
    intermittent = [[c for c in range(n_clients) if rng.rand() < 0.5]
                    for _ in range(rounds)]
    for codec in ("delta", "delta+identity"):
        for h in (4, 0):
            fed = FedConfig(strategy="fedadc", downlink_compressor=codec,
                            downlink_unicast=True, resync_horizon=h,
                            n_clients=n_clients)
            tpl = broadcast_template("fedadc", shapes, fed)
            mcast = _multicast_totals(fed, tpl, full)
            ucast, _, _ = _unicast_totals(fed, tpl, full)
            ib, cu, rs = _unicast_totals(fed, tpl, intermittent)
            rows.append(emit(
                f"comm.{arch}.unicast.{codec.replace('+', '_')}.h{h}", 0,
                f"full_unicast_GB={ucast/2**30:.3f};"
                f"full_multicast_GB={mcast/2**30:.3f};"
                f"full_eq_multicast={ucast == mcast};"
                f"intermittent_GB={ib/2**30:.3f};"
                f"catchups={cu};resyncs={rs}"))
    return rows


def main(rows=None, device=None):
    """``device`` is accepted for the harness and unused: every tree here
    lives on the ``meta`` device."""
    rows = rows if rows is not None else []
    for arch in ("qwen3-4b", "qwen3-14b"):
        n = ARCHS[arch].param_count()
        table = bytes_per_round(n, clients=4)
        base = table["fedavg"]["down"]
        for strat, t in table.items():
            rows.append(emit(
                f"comm.{arch}.{strat}", 0,
                f"up_GB={t['up']/2**30:.2f};down_GB={t['down']/2**30:.2f};"
                f"down_vs_fedavg={t['down']/base:.2f}x"))
        shapes = param_shapes(arch)
        raw = C.raw_nbytes(shapes)
        analytic_up = n * 4
        # measured per-client uplink bytes through each codec's wire format
        for name, kw in UPLINK:
            b = Transport(FedConfig(**kw)).uplink_wire_nbytes(shapes)
            rows.append(emit(
                f"comm.{arch}.measured.up.{name}", 0,
                f"up_GB_per_client={b/2**30:.3f};"
                f"vs_analytic={b/analytic_up:.3f}x;"
                f"vs_raw={raw/b:.2f}x_smaller"))
        # measured per-client downlink bytes: the real broadcast tree per
        # strategy × downlink codec — fedadc's naive 2× shows up because
        # its wire tree carries m̄_t, not because we multiplied by 2
        for strat in ("fedavg", "slowmo", "fedadc"):
            for name, kw in DOWNLINK:
                fed = FedConfig(strategy=strat, **kw)
                tpl = broadcast_template(strat, shapes, fed)
                b = Transport(fed).downlink_wire_nbytes(tpl)
                rows.append(emit(
                    f"comm.{arch}.measured.down.{strat}.{name}", 0,
                    f"down_GB_per_client={b/2**30:.3f};"
                    f"vs_raw_params={b/raw:.2f}x"))
        # the headline: FedADC's Δm̄-coded broadcast back at ~1× raw θ
        # (naive wire: 2×, because the tree carries m̄_t)
        fed = FedConfig(strategy="fedadc", downlink_compressor="delta")
        tpl = broadcast_template("fedadc", shapes, fed)
        b = Transport(fed).downlink_wire_nbytes(tpl)
        naive = Transport(FedConfig(strategy="fedadc")
                          ).downlink_wire_nbytes(tpl)
        rows.append(emit(
            f"comm.{arch}.fedadc_delta_downlink", 0,
            f"vs_raw_params={b/raw:.3f}x;naive={naive/raw:.2f}x;"
            f"le_1p1={b <= 1.1 * raw}"))
        unicast_rows(rows, arch, shapes)
    return rows


if __name__ == "__main__":
    main()
