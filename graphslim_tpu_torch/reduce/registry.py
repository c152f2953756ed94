"""Reduction-method registry: name → family → lazily imported class.

Counterpart of ``graphslim_tpu/reduce/registry.py``: every method the
JAX package registers, in the same families, and its aliases.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    family: str                  # sparsification | coarsening | condensation
    module: str                  # module under graphslim_tpu_torch.reduce
    cls: str
    agg_cls: Optional[str] = None  # aggregated-features variant


_SPECS = [
    # --- coreset sparsification ----------------------------------------
    MethodSpec("random", "sparsification", "coreset", "Random",
               agg_cls="RandomAgg"),
    MethodSpec("kcenter", "sparsification", "coreset", "KCenter",
               agg_cls="KCenterAgg"),
    # kcenter_sample's select() is identical to kcenter upstream
    MethodSpec("kcenter_sample", "sparsification", "coreset", "KCenter"),
    MethodSpec("herding", "sparsification", "coreset", "Herding",
               agg_cls="HerdingAgg"),
    MethodSpec("cent_d", "sparsification", "coreset", "CentD"),
    MethodSpec("cent_p", "sparsification", "coreset", "CentP"),
    # --- edge sparsification -------------------------------------------
    MethodSpec("random_edge", "sparsification", "edge_sparsify",
               "RandomEdge"),
    MethodSpec("g_spar", "sparsification", "edge_sparsify", "GSpar"),
    MethodSpec("local_degree", "sparsification", "edge_sparsify",
               "LocalDegree"),
    MethodSpec("scan", "sparsification", "edge_sparsify", "Scan"),
    MethodSpec("spanning_forest", "sparsification", "edge_sparsify",
               "SpanningForest"),
    MethodSpec("rank_degree", "sparsification", "edge_sparsify",
               "RankDegree"),
    MethodSpec("t_spanner", "sparsification", "edge_sparsify", "TSpanner"),
    # --- coarsening ----------------------------------------------------
    MethodSpec("variation_neighborhoods", "coarsening", "coarsening",
               "VariationNeighborhoods"),
    MethodSpec("variation_edges", "coarsening", "coarsening",
               "VariationEdges"),
    MethodSpec("variation_cliques", "coarsening", "coarsening",
               "VariationCliques"),
    MethodSpec("heavy_edge", "coarsening", "coarsening", "HeavyEdge"),
    MethodSpec("algebraic_jc", "coarsening", "coarsening", "AlgebraicJC"),
    MethodSpec("affinity_gs", "coarsening", "coarsening", "AffinityGS"),
    MethodSpec("kron", "coarsening", "coarsening", "Kron"),
    MethodSpec("clustering", "coarsening", "clustering", "Cluster",
               agg_cls="ClusterAgg"),
    MethodSpec("averaging", "coarsening", "clustering", "Average"),
    MethodSpec("vng", "coarsening", "vng", "VNG"),
    # --- condensation --------------------------------------------------
    MethodSpec("gcond", "condensation", "gcond", "GCond"),
    MethodSpec("doscond", "condensation", "gcond", "DosCond"),
    MethodSpec("gcondx", "condensation", "gcond", "GCondX"),
    MethodSpec("doscondx", "condensation", "gcond", "DosCondX"),
    MethodSpec("gcdm", "condensation", "gcdm", "GCDM"),
    MethodSpec("gcdmx", "condensation", "gcdm", "GCDMX"),
    MethodSpec("sgdd", "condensation", "sgdd", "SGDD"),
    MethodSpec("msgc", "condensation", "msgc", "MSGC"),
    MethodSpec("sfgc", "condensation", "sfgc", "SFGC"),
    MethodSpec("geom", "condensation", "geom", "GEOM"),
    MethodSpec("gcsntk", "condensation", "gcsntk", "GCSNTK"),
    MethodSpec("simgc", "condensation", "simgc", "SimGC"),
    MethodSpec("gdem", "condensation", "gdem", "GDEM"),
    MethodSpec("gecc", "condensation", "gecc", "GECC"),
    MethodSpec("mirage", "condensation", "mirage", "Mirage"),
]

_ALIASES = {"algebraic_JC": "algebraic_jc", "affinity_GS": "affinity_gs",
            "tspanner": "t_spanner", "cluster": "clustering",
            "average": "averaging"}

REGISTRY = {s.name: s for s in _SPECS}


def get_method_spec(method: str) -> MethodSpec:
    """The spec that ``method`` (or its alias) names."""
    method = _ALIASES.get(method, method)
    if method not in REGISTRY:
        raise ValueError(f"Unknown reduction method {method!r}; "
                         f"available: {sorted(REGISTRY)}")
    return REGISTRY[method]


def list_methods(family: Optional[str] = None) -> list[str]:
    """Sorted method names, of one family or of all."""
    return sorted(s.name for s in _SPECS
                  if family is None or s.family == family)


def reducer_class(method: str, agg: bool = False) -> type:
    """The class that ``method`` (or its alias) names; ``agg`` selects
    the aggregated-features variant of a coreset or of clustering."""
    spec = get_method_spec(method)
    cls = spec.agg_cls if agg and spec.agg_cls is not None else spec.cls
    mod = importlib.import_module(f"graphslim_tpu_torch.reduce.{spec.module}")
    return getattr(mod, cls)


def create_reducer(method: str, data, args, **kwargs):
    """Instantiate a reducer on ``data``'s device (``args.agg`` selects
    the aggregated-features variant of a coreset or of clustering);
    ``kwargs`` (e.g. ``labels_syn_override``) pass through to the reducer,
    and a reducer that takes none is built without them, as in the JAX
    package."""
    cls = reducer_class(method, getattr(args, "agg", False))
    try:
        return cls(data, args, **kwargs)
    except TypeError:
        if kwargs:
            # a reducer without override support (edge sparsifiers etc.)
            return cls(data, args)
        raise
