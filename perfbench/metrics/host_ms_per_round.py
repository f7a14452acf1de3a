"""``host_ms_per_round``: host milliseconds a round inside the call into
the round engine (the pod step, or the simulator's ``run_round``), with
no synchronisation: how long the host takes to issue a round, which is
the round's time where the card waits for the host.  The harness's span
around the call, over the window's rounds."""


def read(ctx):
    return ctx.window["host_ms"] / ctx.window["rounds"]
