"""Reduction methods of the port so far: GCond condensation and the
coreset family (Random, KCenter, Herding, CentD, CentP and their
aggregated-features variants)."""

from graphslim_tpu_torch.reduce.registry import create_reducer
from graphslim_tpu_torch.reduce.base import Reducer, class_budgets
