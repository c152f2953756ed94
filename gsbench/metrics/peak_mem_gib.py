"""``torch.cuda.max_memory_allocated()`` over the window (reset after
the warm-up), in GiB."""

UNIT = "GiB"
LAYER = None
MOVES = None


def read(ctx):
    if not ctx.get("peak_bytes"):
        return None
    return ctx["peak_bytes"] / 2 ** 30
