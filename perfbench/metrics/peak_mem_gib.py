"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the
measured window (its peak statistics reset at the window's start), in
GiB.  Read by the harness from the card's caching allocator."""


def read(ctx):
    return ctx.window["peak_bytes"] / 2 ** 30
