"""Pipeline entry point: args → dataset → reduce → evaluate.

Counterpart of ``graphslim_tpu/train_all.py``.  Run as
``python -m graphslim_tpu_torch.train_all -D ogbn-arxiv -M gcond``
(add ``--device cpu`` to run on the CPU; ``--resume`` picks up the train
state a condensation run saved at its last checkpoint; ``--attack
random_adj|random_feat|metattack`` corrupts the graph before the
reduction, :mod:`graphslim_tpu_torch.data.attack`).  The tracker,
profiling and distributed branches are not ported yet and raise when
asked for.
"""

from __future__ import annotations

import logging

from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import Args, get_args
from graphslim_tpu_torch.data import load
from graphslim_tpu_torch.data.attack import attack
from graphslim_tpu_torch.eval import Evaluator
from graphslim_tpu_torch.reduce import create_reducer

log = logging.getLogger("graphslim_tpu_torch")

_NOT_PORTED = {
    "wandb": "tracking.py (ROADMAP.md, queue 1, item 8)",
    "profile": "profiling.py (ROADMAP.md, queue 1, item 15)",
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


def run(args: Args):
    refuse_unported(args)
    graph = load(args.dataset, setting=args.setting, split=args.split,
                 seed=args.seed, data_dir=args.load_path,
                 pre_norm=args.pre_norm, device=args.device)
    utils.seed_everything(args.seed)
    if args.attack is not None:
        graph = attack(graph, args)
    agent = create_reducer(args.method, graph, args)
    reduced = agent.reduce(graph, verbose=args.verbose)
    (mean, std), _ = Evaluator(graph, args).evaluate(
        reduced, args.eval_model, verbose=args.verbose)
    print(f"{args.method} on {args.dataset} r={args.reduction_rate}: "
          f"{mean * 100:.2f} ± {std * 100:.2f}")
    return mean, std


def main():
    run(get_args())


if __name__ == "__main__":
    main()
