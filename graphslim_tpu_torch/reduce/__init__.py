"""Reduction methods of the port so far: the coreset family (Random,
KCenter, Herding, CentD, CentP and their aggregated-features variants),
the condensers of the GCond engine (GCond, DosCond, GCondX, DosCondX,
GCDM, GCDMX, SGDD, MSGC), the clustering coarseners (Cluster,
ClusterAgg, Average, VNG), Mirage and GECC."""

from graphslim_tpu_torch.reduce.registry import create_reducer
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets
