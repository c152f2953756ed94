"""Evaluation-only entry point: load a saved reduced triple, evaluate it.

Counterpart of ``graphslim_tpu/run_eval.py``:
``python -m graphslim_tpu_torch.run_eval -D ogbn-arxiv -M gcond
[--eval_model SGC]`` reads the triple a reduction saved under
``--save_path`` (the layout both packages write,
``{save_path}/reduced_graph/{method}/{dataset}_{r}_{seed}.npz``, under
``{save_path}/corrupt_graph/{attack}/`` with ``--attack``) and evaluates
it on the data it loads, which it does not attack, on the CUDA card, or on
the CPU with ``--device cpu``.  With ``--dist_devices N`` (N > 1) the
validation and test forwards shard over N ranks, under ``torchrun
--standalone --nproc-per-node N -m graphslim_tpu_torch.run_eval ...
--dist_devices N``; only rank 0 prints.
"""

from __future__ import annotations

from typing import Optional

from graphslim_tpu_torch import utils
from graphslim_tpu_torch.config import get_args
from graphslim_tpu_torch.data import get_syn_data, load
from graphslim_tpu_torch.train_all import build_evaluator, run_mesh


def main(argv: Optional[list[str]] = None):
    args = get_args(argv)
    mesh = run_mesh(args)
    data = load(args.dataset, setting=args.setting, split=args.split,
                seed=args.seed, data_dir=args.load_path,
                pre_norm=args.pre_norm, device=args.device)
    utils.seed_everything(args.seed)
    reduced = get_syn_data(args.save_path, args.method, args.dataset,
                           args.reduction_rate, args.seed,
                           model_type=args.eval_model,
                           threshold=args.threshold, device=args.device,
                           attack=args.attack)
    (mean, std), _ = build_evaluator(data, args, mesh).evaluate(
        reduced, args.eval_model, verbose=args.verbose)
    if utils.is_writer():
        print(f"{args.method} on {args.dataset} r={args.reduction_rate} "
              f"[{args.eval_model}]: {mean * 100:.2f} ± {std * 100:.2f}")
    return mean, std


if __name__ == "__main__":
    main()
