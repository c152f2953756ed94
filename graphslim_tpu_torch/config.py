"""Typed configuration + CLI.

Counterpart of ``graphslim_tpu/config.py``.  Precedence is the same: method
defaults (``METHOD_CONFIGS``) → setting rules → explicit command-line flags
win, with ``init`` protected from the method config.  The port adds one
field, ``device`` (the CUDA card unless ``--device cpu``); fields of
methods, models and datasets that are not ported yet are left out with them
(model dropout, BN and weight decay are fixed where the reference fixes
them for this path).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Any, Optional

from graphslim_tpu_torch.method_configs import METHOD_CONFIGS

log = logging.getLogger("graphslim_tpu_torch")


@dataclasses.dataclass
class Args:
    # --- common ---------------------------------------------------------
    dataset: str = "cora"
    method: str = "kcenter"
    setting: Optional[str] = None          # trans | ind (forced per dataset)
    split: str = "fixed"
    reduction_rate: float = -1.0
    seed: int = 1
    verbose: bool = False
    save_path: str = "checkpoints"
    load_path: Optional[str] = None        # dataset dir (None → synthetic)
    pre_norm: bool = True
    agg: bool = False
    attack: Optional[str] = None
    ptb_r: float = 0.25
    prbcd_epochs: int = 120                # PRBCD ascent epochs
    prbcd_fine_tune: int = 30              # last epochs without resampling
    prbcd_block: int = 250_000             # candidate block size
    device: str = "cuda"
    # --- reduction / condensation --------------------------------------
    epochs: int = 1000
    hidden: int = 256
    nlayers: int = 2
    lr: float = 0.01
    condense_model: str = "SGC"
    dis_metric: str = "ours"
    lr_adj: float = 1e-4
    lr_feat: float = 1e-4
    threshold: float = 0.0
    ntrans: int = 1
    outer_loop: int = 10
    inner_loop: int = 1
    init: str = "random"
    alpha: float = 0.1
    activation: str = "relu"
    trans_layers: int = 2                  # SGFormer's transformer depth
    # SGDD (IGNR generator, spectral-OT regularizer)
    mx_size: int = 100
    opt_scale: float = 1e-11
    ep_ratio: float = 0.5
    # MSGC: skeleton graphs in a batch (16 for msgc, set by finalize)
    batch_adj: int = 1
    # GECC: hop weights (X, ÂX, Â²X), hops, fuzzy c-means exponent and
    # iterations (fuzziness 1 → k-means)
    agg_alpha: float = 0.9
    agg_beta: float = 0.9
    agg_gamma: float = -0.1
    fuzziness: float = 1.3
    rep_fuzz: int = 50
    depth: int = 2
    # GCSNTK: SNTK aggregations and ReLU layers per aggregation, the
    # aggregation's scaling ('add' | 'average'), KRR ridge
    K: int = 2
    L: int = 2
    scale: str = "average"
    ridge: float = 1.0
    # SimGC: alignment and smoothness weights; lr_teacher is shared with
    # the SFGC/GEOM experts
    feat_alpha: float = 10.0
    smoothness_alpha: float = 0.1
    lr_teacher: float = 0.4
    # SFGC/GEOM expert trajectories ('Adam' | 'SGD') and the student's
    # unrolled steps
    teacher_epochs: int = 800
    expert_epochs: int = 1500
    syn_steps: int = 500
    start_epoch: int = 30
    num_experts: int = 20
    lr_student: float = 0.5
    wd_teacher: float = 0.0
    mom_teacher: float = 0.0
    optim: str = "Adam"
    optim_lr: int = 0
    no_buff: bool = False
    # GEOM: soft labels, the curriculum schedule and the start window;
    # beta weighs GEOM's KL term and GDEM's class-embedding loss
    soft_label: int = 0
    lr_y: float = 5e-5
    beta: float = 0.1
    T: int = 1500
    lam: float = 0.75
    scheduler: str = "geom"
    min_start_epoch: int = 0
    max_start_epoch: int = 200
    max_start_epoch_s: int = 50
    # GDEM: eigenvectors kept and the share of the smallest, their lr,
    # orthogonality weight, eigenvector/feature steps of a period, and the
    # large-graph eigensolver (auto | host | device; auto is the device on
    # the card, the host ARPACK on the CPU)
    eigen_k: int = 60
    ratio: float = 0.8
    lr_eigenvec: float = 0.01
    gamma: float = 0.5
    e1: int = 10
    e2: int = 15
    eigen_backend: str = "auto"
    # Edge sparsification and structural coarsening: the t-spanner's
    # stretch; the matching coarseners' strategy (greedy | optimal, the
    # exact blossom) and proximity measure (empty: each method's own;
    # heavy_edge, heavy_edge_degree, algebraic_JC, algebraic_GS,
    # affinity_GS, min_expected_loss, min_expected_gradient_loss, rss,
    # rss_lanczos, rss_cheby)
    ts: int = 4
    coarsen_strategy: str = "greedy"
    coarsen_measure: str = ""
    # --- evaluation -----------------------------------------------------
    run_eval: int = 10
    run_inter_eval: int = 3
    eval_interval: int = 100
    eval_epochs: int = 300
    eval_model: str = "GCN"
    resume: bool = False    # resume condensation from its last train state
    # --- profiling and tracking -----------------------------------------
    profile: bool = False   # torch.profiler trace of reduce()
    wandb: bool = False     # WandB tracking (NullTracker without wandb)
    wandb_project: str = "graphslim_tpu"
    wandb_run_name: Optional[str] = None
    wandb_required: bool = False
    # --- not ported yet (raises when asked for) -------------------------
    dist_devices: int = 0
    # --- derived (filled by finalize) -----------------------------------
    metric: str = "accuracy"
    checkpoints: tuple = ()

    def replace(self, **kw) -> "Args":
        return dataclasses.replace(self, **kw)


REPRESENTATIVE_R = {
    "cora": 0.5, "citeseer": 0.5, "pubmed": 0.1, "flickr": 0.01,
    "reddit": 0.001, "ogbn-arxiv": 0.01, "yelp": 0.001, "amazon": 0.002,
    "synth-small": 0.25, "synth-ind-small": 0.25,
}

TRANS_DATASETS = {"cora", "citeseer", "pubmed", "ogbn-arxiv", "synth-small",
                  "photo", "computers", "cs", "physics", "dblp"}
IND_DATASETS = {"flickr", "reddit", "amazon", "yelp", "synth-ind-small"}

# Synthetic twins inherit their real counterpart's method configs.
_DATASET_ALIASES = {"synth-small": "cora", "synth-hard": "cora"}


def apply_method_config(args: Args, explicit: set[str]) -> Args:
    mconf = METHOD_CONFIGS.get(args.method, {})
    dname = args.dataset if args.dataset in mconf \
        else _DATASET_ALIASES.get(args.dataset, args.dataset)
    conf = mconf.get(dname, {})
    updates: dict[str, Any] = {}
    for key, value in conf.items():
        if key in explicit:
            continue
        if hasattr(args, key):
            updates[key] = value
    if args.method == "msgc" and "batch_adj" not in explicit:
        updates["batch_adj"] = 16
    return args.replace(**updates)


def apply_setting_config(args: Args, explicit: set[str]) -> Args:
    """Representative rates, forced setting, metric and the checkpoint
    schedule (every ``epochs // 10`` epochs, from -1)."""
    updates: dict[str, Any] = {}
    if args.reduction_rate == -1.0:
        updates["reduction_rate"] = REPRESENTATIVE_R.get(args.dataset, 0.5)
    if args.dataset in TRANS_DATASETS:
        updates["setting"] = "trans"
    elif args.dataset in IND_DATASETS:
        updates["setting"] = "ind"
    elif args.setting is None:
        updates["setting"] = "trans"
    updates["metric"] = ("f1_macro" if args.dataset in ("yelp", "amazon")
                         else "accuracy")
    if "run_inter_eval" not in explicit:
        updates["run_inter_eval"] = 3
    eval_interval = max(args.epochs // 10, 1)
    updates["eval_interval"] = eval_interval
    updates["checkpoints"] = tuple(
        range(-1, args.epochs + 1, eval_interval))
    if "eval_epochs" not in explicit:
        updates["eval_epochs"] = 300
    return args.replace(**updates)


def finalize(args: Args, explicit: Optional[set[str]] = None) -> Args:
    """Full precedence chain → run config."""
    explicit = explicit or set()
    args = apply_method_config(args, explicit)
    return apply_setting_config(args, explicit)


def get_args(argv: Optional[list[str]] = None) -> Args:
    """CLI entry: one ``--flag`` per ``Args`` field."""
    parser = argparse.ArgumentParser("graphslim-tpu-torch")
    short = {"dataset": "-D", "method": "-M", "reduction_rate": "-R",
             "seed": "-S", "epochs": "-E", "hidden": "-H",
             "verbose": "-V", "attack": "-A", "ptb_r": "-P"}
    for f in dataclasses.fields(Args):
        if f.name in ("metric", "checkpoints"):
            continue
        names = [f"--{f.name}"] + ([short[f.name]] if f.name in short
                                   else [])
        if isinstance(f.default, bool):
            parser.add_argument(*names,
                                action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            typ = type(f.default) if f.default is not None else str
            parser.add_argument(*names, type=typ, default=f.default)
    ns = parser.parse_args(argv)
    explicit = {f.name for f in dataclasses.fields(Args)
                if hasattr(ns, f.name) and getattr(ns, f.name) != f.default}
    args = Args(**{f.name: getattr(ns, f.name)
                   for f in dataclasses.fields(Args) if hasattr(ns, f.name)})
    args = finalize(args, explicit)
    _setup_logging(args)
    return args


def _setup_logging(args: Args) -> None:
    """File logger under ``{save_path}/logs/{method}/`` (rank 0 of a
    distributed run only)."""
    from graphslim_tpu_torch.utils import is_writer

    if not is_writer():
        return
    log_dir = os.path.join(args.save_path, "logs", args.method)
    os.makedirs(log_dir, exist_ok=True)
    handler = logging.FileHandler(
        os.path.join(log_dir, f"{args.dataset}_{args.reduction_rate}.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.DEBUG if args.verbose else logging.INFO)
