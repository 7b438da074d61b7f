from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset

__all__ = ["DenoiserDataset", "Loader", "generate_dataset"]
