"""Evaluation: downstream-GNN accuracy of a reduced graph."""

from graphslim_tpu_torch.eval.evaluator import Evaluator
