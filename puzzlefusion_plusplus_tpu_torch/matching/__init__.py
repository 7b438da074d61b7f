"""The Jigsaw matcher (port of ``puzzlefusion_plusplus_tpu/matching/``): the model, its
training (``matching.train``) and the matching-data writer (``matching.eval``,
``matching.generate``) that the denoiser's test-mode dataset and the engine read."""

from puzzlefusion_plusplus_tpu_torch.matching.alignment import (
    chordal_rotation_averaging,
    global_alignment,
    ransac_transform,
    spanning_tree_alignment,
    weighted_horn,
)
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.matching.model import JigsawModel
from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import hungarian, sinkhorn_log

__all__ = [
    "AllPieceMatchingDataset",
    "JigsawModel",
    "chordal_rotation_averaging",
    "global_alignment",
    "hungarian",
    "ransac_transform",
    "sinkhorn_log",
    "spanning_tree_alignment",
    "weighted_horn",
]
