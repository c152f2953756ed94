"""Reduction-method registry: name → lazily imported class.

Counterpart of ``graphslim_tpu/reduce/registry.py``: every method the
JAX package registers, and its aliases.
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
    "random_edge": ("edge_sparsify", "RandomEdge", None),
    "g_spar": ("edge_sparsify", "GSpar", None),
    "local_degree": ("edge_sparsify", "LocalDegree", None),
    "scan": ("edge_sparsify", "Scan", None),
    "spanning_forest": ("edge_sparsify", "SpanningForest", None),
    "rank_degree": ("edge_sparsify", "RankDegree", None),
    "t_spanner": ("edge_sparsify", "TSpanner", None),
    "variation_neighborhoods": ("coarsening", "VariationNeighborhoods",
                                None),
    "variation_edges": ("coarsening", "VariationEdges", None),
    "variation_cliques": ("coarsening", "VariationCliques", None),
    "heavy_edge": ("coarsening", "HeavyEdge", None),
    "algebraic_jc": ("coarsening", "AlgebraicJC", None),
    "affinity_gs": ("coarsening", "AffinityGS", None),
    "kron": ("coarsening", "Kron", None),
}

_ALIASES = {"algebraic_JC": "algebraic_jc", "affinity_GS": "affinity_gs",
            "tspanner": "t_spanner", "cluster": "clustering",
            "average": "averaging"}


def reducer_class(method: str, agg: bool = False) -> type:
    """The class that ``method`` (or its alias) names; ``agg`` selects
    the aggregated-features variant of a coreset or of clustering."""
    method = _ALIASES.get(method, method)
    if method not in _PORTED:
        raise ValueError(f"Unknown reduction method {method!r}; "
                         f"available: {sorted(_PORTED)}")
    module, cls, agg_cls = _PORTED[method]
    if agg and agg_cls is not None:
        cls = agg_cls
    mod = importlib.import_module(f"graphslim_tpu_torch.reduce.{module}")
    return getattr(mod, cls)


def create_reducer(method: str, data, args, **kwargs):
    """Instantiate a reducer on ``data``'s device (``args.agg`` selects
    the aggregated-features variant of a coreset or of clustering);
    ``kwargs`` (e.g. ``labels_syn_override``) pass through to the
    reducer."""
    cls = reducer_class(method, getattr(args, "agg", False))
    return cls(data, args, **kwargs)
