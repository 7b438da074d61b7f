"""Geometry ops. Each TPU Pallas kernel of the inference path has a CUDA kernel under
``csrc/`` with a wrapper here; a wrapper runs its plain PyTorch version on CPU tensors and
launches its kernel (counting the launch in ``<wrapper>.launches``) on CUDA tensors.

| kernel | wrapper | CUDA source |
| S | ``sa_fused.sa_stage_fused_cached`` | ``csrc/sa_cached.cu`` |
| F | ``fps.farthest_point_sample`` | ``csrc/fps.cu`` |
| G | ``gather.gather_points`` | ``csrc/gather.cu`` |
| N | ``chamfer.nn_distance`` | ``csrc/nn.cu`` |
| M | ``chamfer.masked_pairwise_nn`` | ``csrc/nn.cu`` |
"""

from puzzlefusion_plusplus_tpu_torch.ops.chamfer import masked_pairwise_nn, nn_distance
from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample
from puzzlefusion_plusplus_tpu_torch.ops.gather import gather_points
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import sa_stage_fused_cached

KERNEL_WRAPPERS = {
    "S": sa_stage_fused_cached,
    "F": farthest_point_sample,
    "G": gather_points,
    "N": nn_distance,
    "M": masked_pairwise_nn,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
