"""Reduction-method registry: name → lazily imported class.

Counterpart of ``graphslim_tpu/reduce/registry.py``.  Every method the
JAX package registers is known here; the ones this port does not have yet
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import importlib

# name → (module under graphslim_tpu_torch.reduce, class, class of the
# aggregated-features variant that ``args.agg`` selects, or None)
_PORTED = {
    "random": ("coreset", "Random", "RandomAgg"),
    "kcenter": ("coreset", "KCenter", "KCenterAgg"),
    # kcenter_sample's select() is identical to kcenter upstream
    "kcenter_sample": ("coreset", "KCenter", None),
    "herding": ("coreset", "Herding", "HerdingAgg"),
    "cent_d": ("coreset", "CentD", None),
    "cent_p": ("coreset", "CentP", None),
    "gcond": ("gcond", "GCond", None),
    "doscond": ("gcond", "DosCond", None),
    "gcondx": ("gcond", "GCondX", None),
    "doscondx": ("gcond", "DosCondX", None),
    "gcdm": ("gcdm", "GCDM", None),
    "gcdmx": ("gcdm", "GCDMX", None),
    "sgdd": ("sgdd", "SGDD", None),
    "clustering": ("clustering", "Cluster", "ClusterAgg"),
    "averaging": ("clustering", "Average", None),
    "vng": ("vng", "VNG", None),
    "msgc": ("msgc", "MSGC", None),
    "mirage": ("mirage", "Mirage", None),
    "gecc": ("gecc", "GECC", None),
    "gcsntk": ("gcsntk", "GCSNTK", None),
    "simgc": ("simgc", "SimGC", None),
    "sfgc": ("sfgc", "SFGC", None),
    "geom": ("geom", "GEOM", None),
    "gdem": ("gdem", "GDEM", None),
}

# name → ROADMAP.md queue-1 item that ports it
_QUEUED = {
    **{m: 11 for m in ("random_edge", "g_spar", "local_degree", "scan",
                       "spanning_forest", "rank_degree", "t_spanner",
                       "variation_neighborhoods", "variation_edges",
                       "variation_cliques", "heavy_edge", "algebraic_jc",
                       "affinity_gs", "kron")},
}

_ALIASES = {"algebraic_JC": "algebraic_jc", "affinity_GS": "affinity_gs",
            "tspanner": "t_spanner", "cluster": "clustering",
            "average": "averaging"}


def create_reducer(method: str, data, args, **kwargs):
    """Instantiate a reducer on ``data``'s device (``args.agg`` selects
    the aggregated-features variant of a coreset or of clustering);
    ``kwargs`` (e.g. ``labels_syn_override``) pass through to the
    reducer."""
    method = _ALIASES.get(method, method)
    if method in _QUEUED:
        raise NotImplementedError(
            f"reduction method {method!r} is not ported yet (ROADMAP.md, "
            f"queue 1, item {_QUEUED[method]})")
    if method not in _PORTED:
        raise ValueError(f"Unknown reduction method {method!r}; "
                         f"available: {sorted(_PORTED)}")
    module, cls, agg_cls = _PORTED[method]
    if getattr(args, "agg", False) and agg_cls is not None:
        cls = agg_cls
    mod = importlib.import_module(f"graphslim_tpu_torch.reduce.{module}")
    return getattr(mod, cls)(data, args, **kwargs)
