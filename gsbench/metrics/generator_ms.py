"""Mean device ms of one generator forward (``generator_forward``: the
scorer over every skeleton entry, the scatter into the ``[B, n, n]``
batch, its normalization) over a traced run's unprofiled stretch, between
the CUDA events the harness records around the call.  A faster
generator shortens ``setup_s`` through the warm-up epoch."""

UNIT = "ms"
LAYER = "MSGC generator: reduce/msgc.py"
MOVES = "setup_s"


def read(ctx):
    ms = ctx.get("generator_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
