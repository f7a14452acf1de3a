"""``mfu``: the whole round's share of the card's peak, in %: the model's
FLOPs a round (``yardstick/flops.py``: 6·N·tokens for a language model,
3 × 2·MACs × images for a convolutional one; recomputation not counted)
over the round's seconds in the traced run's unprofiled window, against
the peak of the fastest arithmetic the configuration permits
(``peak`` in its file: bf16 989 TFLOP/s, TF32 494.5 on an H100 SXM5)."""


def read(ctx):
    round_s = ctx.window["seconds"] / ctx.window["rounds"]
    peak = ctx.peaks.flops(ctx.cell.config["peak"])
    return 100.0 * ctx.engine.flops_per_round() / round_s / peak
