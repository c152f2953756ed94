"""Evaluation: downstream-GNN accuracy, cross-architecture tables, NAS
correlation, graph properties and the membership-inference attack."""

from graphslim_tpu_torch.eval.evaluator import Evaluator
from graphslim_tpu_torch.eval.nas import NasEvaluator
from graphslim_tpu_torch.eval.property import PropertyEvaluator
from graphslim_tpu_torch.eval.mia import inference_via_confidence, mia_attack
