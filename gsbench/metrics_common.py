"""Helpers the metric readers share."""

PGE_KERNELS = ("pge_fwd_kernel", "pge_fwd_simt_kernel", "pge_bwd_kernel")


def is_pge(name: str) -> bool:
    return any(k in name for k in PGE_KERNELS)


def roofline(ctx, names: tuple, least_key: str):
    """100 × least time / mean device time a launch of the kernels named,
    or None where the stretch launched none."""
    k = [(a, b) for name, a, b in ctx.get("kernels") or ()
         if any(n in name for n in names)]
    if not k:
        return None
    mean_s = sum(b - a for a, b in k) / len(k) / 1e9
    return 100.0 * ctx[least_key] / mean_s
