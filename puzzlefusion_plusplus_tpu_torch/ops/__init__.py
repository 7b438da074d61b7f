"""Geometry ops. Each TPU Pallas kernel on the port's paths has a CUDA kernel under ``csrc/``
with a wrapper here; a wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel (counting the launch in ``<wrapper>.launches``) on CUDA tensors.

| kernel | wrapper | CUDA source |
| S | ``sa_fused.sa_stage_fused_cached`` | ``csrc/sa_cached.cu`` |
| F | ``fps.farthest_point_sample`` | ``csrc/fps.cu`` |
| G | ``gather.gather_points`` | ``csrc/gather.cu`` |
| N | ``chamfer.nn_distance`` | ``csrc/nn.cu`` |
| M | ``chamfer.masked_pairwise_nn`` | ``csrc/nn.cu`` |
| A | ``gather.gather_points_approx`` (G's kernel, its own count) | ``csrc/gather.cu`` |
| B | ``gather.scatter_add`` (backward of G, A and of N's target side) | ``csrc/scatter_add.cu`` |
| R | ``sa_fused.sa_stage_fused`` (the frozen encoder's ``fused='always'`` mode) | ``csrc/sa_raw.cu`` |
| P | ``fps.farthest_point_sample_per_cloud`` (the engine's merge resample) | ``csrc/fps.cu`` |
| S int8 | ``sa_fused.sa_stage_cached_int8`` (S under ``PFPP_SA_GATHER=int8``, SA2 and SA3) | ``csrc/sa_cached.cu`` |
| S int8 quantize | ``sa_fused.sa_quantize`` (the codes S int8 gathers) | ``csrc/sa_cached.cu`` |
| D | ``dense.split_linear`` (the denoiser's inference linears) | ``csrc/dense.cu`` |

"S pre-split" counts the launches of S (either instantiation) that were handed W2 and W3 as
planes split beforehand (``sa_fused.tf32_planes``; the frozen encoder's), not a kernel.

S and R share their layers 2-3 and max over K (``csrc/sa_common.cuh``); P returns F's indices.

D replaces no TPU kernel: the JAX denoiser's Dense layers go to XLA. It was added because,
with TF32 off, cuBLAS runs the denoiser's fp32 linears as SIMT FFMA kernels that never touch
the tensor cores (about two thirds of the b8 engine's step). Bound: 3xTF32, three TF32 MMAs
a product at 495 TFLOP/s. Design: S's 3xTF32 wgmma passes (``sa_common.cuh``) on weights
split once into TF32 planes (``dense.SplitWeights``, rebuilt in place when a weight changes);
a lane loads and splits its own rows of x in registers; a producer warp streams the planes by
bulk copies; the block shape and a split of K over a thread block cluster follow (M, N, K)
(``dense.tile_shape``); the epilogue adds the bias and, for the GEGLU projection, applies
h * gelu(gate).
"""

from puzzlefusion_plusplus_tpu_torch.ops.chamfer import masked_pairwise_nn, nn_distance
from puzzlefusion_plusplus_tpu_torch.ops.dense import split_linear
from puzzlefusion_plusplus_tpu_torch.ops.fps import (
    farthest_point_sample,
    farthest_point_sample_per_cloud,
)
from puzzlefusion_plusplus_tpu_torch.ops.gather import (
    gather_points,
    gather_points_approx,
    scatter_add,
)
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import (
    presplit,
    sa_quantize,
    sa_stage_cached_int8,
    sa_stage_fused,
    sa_stage_fused_cached,
)

KERNEL_WRAPPERS = {
    "S": sa_stage_fused_cached,
    "F": farthest_point_sample,
    "G": gather_points,
    "N": nn_distance,
    "M": masked_pairwise_nn,
    "A": gather_points_approx,
    "B": scatter_add,
    "R": sa_stage_fused,
    "P": farthest_point_sample_per_cloud,
    "S int8": sa_stage_cached_int8,
    "S int8 quantize": sa_quantize,
    "S pre-split": presplit,
    "D": split_linear,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
