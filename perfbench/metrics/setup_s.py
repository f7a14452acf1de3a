"""``setup_s``: seconds from the process's start to the first timed
round: imports, the kernels' build check, traffic and weights made from
the seed, and the set-up rounds the comparison reads.  Host clock."""


def read(ctx):
    return ctx.setup_s
