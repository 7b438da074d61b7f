from puzzlefusion_plusplus_tpu_torch.data.datasets import (
    DenoiserDataset,
    VerifierDataset,
    VQVAEDataset,
)
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader, prefetch_batches
from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset

__all__ = ["DenoiserDataset", "Loader", "VQVAEDataset", "VerifierDataset", "generate_dataset",
           "prefetch_batches"]
