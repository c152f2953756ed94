"""Model zoo registry (the models of this slice: SGC and GCN)."""

from graphslim_tpu_torch.models.base import (
    GNNModel, ModelConfig, aggregate, aggregate_block, is_skeleton_batch,
    layer_aggregate,
)
from graphslim_tpu_torch.models.zoo import GCN, SGC
from graphslim_tpu_torch.models.trainer import (
    TrainConfig, fit_with_val, evaluate,
)

MODEL_REGISTRY = {"GCN": GCN, "SGC": SGC}
_NOT_PORTED = {"MLP", "APPNP", "Cheby", "ChebNet", "GraphSage", "SAGE",
               "GAT", "SGFormer"}


def get_model(name: str, cfg: ModelConfig) -> GNNModel:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md, queue 1, "
            "item 12)")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg)
