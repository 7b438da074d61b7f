"""The auto-agglomerative engine and the frozen-encoder sampler (port of
``puzzlefusion_plusplus_tpu/inference``), with the JAX package's nine names."""

from puzzlefusion_plusplus_tpu_torch.inference.engine import (
    AgglConfig,
    AgglState,
    auto_agglomerate,
    auto_agglomerate_batch,
    connected_components,
)
from puzzlefusion_plusplus_tpu_torch.inference.sampler import (
    FrozenEncoder,
    ddpm_sample,
    extract_features,
    make_frozen_encoder,
)

__all__ = [
    "AgglConfig",
    "AgglState",
    "auto_agglomerate",
    "auto_agglomerate_batch",
    "connected_components",
    "FrozenEncoder",
    "ddpm_sample",
    "extract_features",
    "make_frozen_encoder",
]
