"""Model zoo registry (counterpart of ``graphslim_tpu/models/__init__.py``:
the same ten names, ``ChebNet`` and ``SAGE`` aliases)."""

from graphslim_tpu_torch.models.base import (
    GNNModel, ModelConfig, aggregate, aggregate_block, is_skeleton_batch,
    layer_aggregate,
)
from graphslim_tpu_torch.models.gat import GAT
from graphslim_tpu_torch.models.sgformer import SGFormer
from graphslim_tpu_torch.models.zoo import (
    APPNP, GCN, MLP, SGC, Cheby, GraphSage,
)
from graphslim_tpu_torch.models.trainer import (
    TrainConfig, evaluate, fit_multi_seed, fit_with_val, prepare_adj,
)

MODEL_REGISTRY = {
    "MLP": MLP,
    "GCN": GCN,
    "SGC": SGC,
    "APPNP": APPNP,
    "Cheby": Cheby,
    "ChebNet": Cheby,
    "GraphSage": GraphSage,
    "SAGE": GraphSage,
    "GAT": GAT,
    "SGFormer": SGFormer,
}


def get_model(name: str, cfg: ModelConfig) -> GNNModel:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](cfg)
