"""Reduction methods of this slice: GCond condensation and the Random
coreset it starts from."""

from graphslim_tpu_torch.reduce.registry import create_reducer
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets
