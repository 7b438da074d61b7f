"""puzzlefusion_plusplus_tpu_torch — the PyTorch/CUDA port of ``puzzlefusion_plusplus_tpu``.

The JAX package beside it is the reference this port is held against. This package imports
``torch``, numpy and scipy only, and never the JAX package: where it needs one of that
package's numpy-only modules it keeps its own copy.

* ``utils``     — quaternion/SE(3) transforms, part compaction, metrics, the typed config.
* ``models``    — DDPM scheduler, embeddings, the VQ-VAE, the denoiser and verifier
                  transformers (``nn.Module``s with the original repo's keys).
* ``ops``       — geometry ops; each of the JAX package's Pallas kernels is a CUDA kernel
                  for Hopper under ``csrc/``, with a plain PyTorch version beside it.
* ``inference`` — the frozen encoder, the sampler, the auto-agglomerative
                  denoise-verify-merge engine and its entry point.
* ``training``  — VQ-VAE, denoiser and verifier training, checkpoints, device parity.
* ``data``      — synthetic fixtures, the datasets, the loader, part bucketing.
* ``convert``   — flax parameter trees -> torch ``state_dict``s.
* ``parallel``  — data parallelism on ``torch.distributed`` (``trainer.num_devices``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
