"""The distributed layer on ``torch.distributed``: meshes, sharded SpMM,
the cross-shard row gather, class-parallel matching and seed-parallel
evaluation.

Counterpart of ``graphslim_tpu/dist/``:

* **node-partitioned full-graph SpMM** (:mod:`.spmm`): rows sharded over
  the ranks, features replicated, all-gathered or exchanged at the
  partition's boundary (the ragged halo exchange overlapped with the
  interior product), each rank's products on the blocked SpMM kernel;
* **class-parallel gradient matching** (:mod:`.matching`): GCond's
  per-class match terms shard over the ranks and the loss sums;
* **seed-parallel evaluation** (:mod:`.evalp`).

Every rank runs the whole program (``torchrun --nproc-per-node N``); a
function of this layer takes and returns the calling rank's blocks.
"""

from graphslim_tpu_torch.dist.evalp import sharded_multi_seed
from graphslim_tpu_torch.dist.gather import (make_sharded_row_gather,
                                             sharded_row_gather_local)
from graphslim_tpu_torch.dist.matching import (build_sharded_match,
                                               pad_classes)
from graphslim_tpu_torch.dist.mesh import make_mesh, make_mesh_2d
from graphslim_tpu_torch.dist.spmm import (DistAdj, PaddedDistAdj,
                                           build_dist_adj, edge_cut_order,
                                           partition_rows,
                                           partition_rows_halo,
                                           partition_rows_halo_ragged,
                                           reorder_adj,
                                           sharded_graph_forward,
                                           shard_spmm, shard_spmm_halo,
                                           shard_spmm_halo_ragged)

__all__ = [
    "make_mesh", "make_mesh_2d", "partition_rows", "edge_cut_order",
    "reorder_adj", "partition_rows_halo", "partition_rows_halo_ragged",
    "shard_spmm", "shard_spmm_halo", "shard_spmm_halo_ragged", "DistAdj",
    "PaddedDistAdj", "build_dist_adj", "sharded_graph_forward",
    "sharded_row_gather_local", "make_sharded_row_gather", "pad_classes",
    "build_sharded_match", "sharded_multi_seed",
]
