"""Pipeline entry point: args → dataset → reduce → evaluate.

Counterpart of ``graphslim_tpu/train_all.py``.  Run as
``python -m graphslim_tpu_torch.train_all -D ogbn-arxiv -M gcond``
(add ``--device cpu`` to run on the CPU; ``--resume`` picks up the train
state a condensation run saved at its last checkpoint; ``--attack
random_adj|random_feat|metattack`` corrupts the graph before the
reduction, :mod:`graphslim_tpu_torch.data.attack`; ``--profile`` writes a
torch.profiler trace of the reduction under
``{save_path}/traces/{method}_{dataset}/``; ``--wandb`` logs the graphs'
summaries and the accuracy to WandB, or to nothing when it is not
installed).

``--dist_devices N`` (N > 1) runs under a launcher with N ranks, one a
device: ``torchrun --standalone --nproc-per-node N -m
graphslim_tpu_torch.train_all -D ogbn-arxiv -M gcond --dist_devices N``
(NCCL on the cards; gloo with ``--device cpu``).  A condensation engine
then shards its per-class gradient matching over the ranks
(``enable_distributed``), and the evaluator its validation and test
forwards (:mod:`graphslim_tpu_torch.dist`).  Only rank 0 prints the
result, logs to the tracker and writes the artifact and the train state.
Without enough ranks ``make_mesh`` raises; ``--dist_devices`` ≤ 1 stays
local.
"""

from __future__ import annotations

import logging

import torch

from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, get_args
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.data.attack import attack
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.graph import SparseAdj
from graphslim_tpu_torch.profiling import trace
from graphslim_tpu_torch.reduce import create_reducer
from graphslim_tpu_torch.tracking import build_tracker, graph_summary

log = logging.getLogger("graphslim_tpu_torch")

def reduced_edges(reduced) -> int:
    """Entries of the reduced adjacency, as the JAX package counts them
    (the nonzeros of ``dense_adj()``; ``n_syn`` for the identity), from
    what is stored: a ``SparseAdj``'s nonzero values, a dense tensor's
    nonzeros on its device.  Nothing is densified."""
    adj = reduced.adj
    if adj is None:
        return reduced.n_syn
    if isinstance(adj, SparseAdj):
        return int(torch.count_nonzero(adj.values_or_ones()))
    return int(torch.count_nonzero(adj))


def run_mesh(args: Args):
    """The mesh of ``--dist_devices`` ranks when that is above 1, else
    None; built before any work, so a launcher with too few ranks fails
    first."""
    if args.dist_devices <= 1:
        return None
    from graphslim_tpu_torch.dist import make_mesh
    return make_mesh(args.dist_devices, device=args.device)


def build_evaluator(graph, args: Args, mesh=None) -> Evaluator:
    """The evaluator of a run: its validation and test forwards
    node-sharded over ``mesh`` when given, else local."""
    evaluator = Evaluator(graph, args)
    if mesh is not None:
        evaluator.enable_distributed(mesh)
    return evaluator


def run(args: Args):
    mesh = run_mesh(args)
    graph = load(args.dataset, setting=args.setting, split=args.split,
                 seed=args.seed, data_dir=args.load_path,
                 pre_norm=args.pre_norm, device=args.device)
    utils.seed_everything(args.seed)
    if args.attack is not None:
        graph = attack(graph, args)
    tracker = build_tracker(args)
    tracker.log_graph("original", graph_summary(graph.n_nodes,
                                                graph.adj.nnz))
    agent = create_reducer(args.method, graph, args)
    if mesh is not None and hasattr(agent, "enable_distributed"):
        agent.enable_distributed(mesh=mesh)
    with trace(f"{args.save_path}/traces/{args.method}_{args.dataset}",
               enabled=args.profile, device=args.device):
        reduced = agent.reduce(graph, verbose=args.verbose)
    tracker.log_graph("reduced", graph_summary(reduced.n_syn,
                                               reduced_edges(reduced)))
    (mean, std), _ = build_evaluator(graph, args, mesh).evaluate(
        reduced, args.eval_model, verbose=args.verbose)
    if utils.is_writer():
        tracker.log_metrics({"acc_mean": mean, "acc_std": std})
        tracker.finish()
        print(f"{args.method} on {args.dataset} r={args.reduction_rate}: "
              f"{mean * 100:.2f} ± {std * 100:.2f}")
    return mean, std


def main():
    run(get_args())


if __name__ == "__main__":
    main()
