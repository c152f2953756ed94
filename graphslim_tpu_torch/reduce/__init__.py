"""Reduction methods of the port, all 38 that the JAX package registers:
the coreset family (Random, KCenter, Herding, CentD, CentP and their
aggregated-features variants), the edge sparsifiers (RandomEdge, GSpar,
Scan, LocalDegree, SpanningForest, RankDegree, TSpanner), the structural
coarseners (the variation family, HeavyEdge, AlgebraicJC, AffinityGS,
Kron), the clustering coarseners (Cluster, ClusterAgg, Average, VNG), the
condensers of the GCond engine (GCond, DosCond, GCondX, DosCondX, GCDM,
GCDMX, SGDD, MSGC), Mirage, GECC, GCSNTK, SimGC, SFGC, GEOM and GDEM."""

from graphslim_tpu_torch.reduce.registry import (
    create_reducer, get_method_spec, list_methods, MethodSpec,
)
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets
