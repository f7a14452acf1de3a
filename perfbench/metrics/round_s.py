"""``round_s``: seconds a federated round, the measured window's wall time
(from its first round's start to ``torch.cuda.synchronize()`` after its
last) over the rounds completed in it.  Host clock."""


def read(ctx):
    return ctx.window["seconds"] / ctx.window["rounds"]
