"""``stage_ms_per_round``: host milliseconds a round in the simulator's
data staging (``next_round_inputs``: picks, numpy gather of the batches,
host-to-device copy from pageable memory).  The harness's span around the
call, over the window's rounds; nothing where the engine stages no data
(the pod engine's tokens stay on the card)."""


def read(ctx):
    ms = ctx.window["stage_ms"]
    return ms / ctx.window["rounds"] if ms > 0 else None
