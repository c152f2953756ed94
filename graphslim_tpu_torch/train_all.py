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
installed).  The distributed branch is not ported yet and raises when
asked for.
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

_NOT_PORTED = {
    "dist_devices": "dist/ (ROADMAP.md, queue 1, item 14)",
}


def refuse_unported(args: Args, fields=tuple(_NOT_PORTED)) -> None:
    """Raise for any of ``fields`` that asks for a branch not ported."""
    for field in fields:
        value = getattr(args, field)
        if value and not (field == "dist_devices" and value <= 1):
            raise NotImplementedError(f"--{field} needs "
                                      f"{_NOT_PORTED[field]}, which is not "
                                      "ported yet")


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


def run(args: Args):
    refuse_unported(args)
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
    with trace(f"{args.save_path}/traces/{args.method}_{args.dataset}",
               enabled=args.profile, device=args.device):
        reduced = agent.reduce(graph, verbose=args.verbose)
    tracker.log_graph("reduced", graph_summary(reduced.n_syn,
                                               reduced_edges(reduced)))
    (mean, std), _ = Evaluator(graph, args).evaluate(
        reduced, args.eval_model, verbose=args.verbose)
    tracker.log_metrics({"acc_mean": mean, "acc_std": std})
    tracker.finish()
    print(f"{args.method} on {args.dataset} r={args.reduction_rate}: "
          f"{mean * 100:.2f} ± {std * 100:.2f}")
    return mean, std


def main():
    run(get_args())


if __name__ == "__main__":
    main()
