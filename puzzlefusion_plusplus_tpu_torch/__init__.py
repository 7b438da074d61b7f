"""puzzlefusion_plusplus_tpu_torch — the PyTorch/CUDA port of ``puzzlefusion_plusplus_tpu``.

The JAX package beside it is the reference this port is held against. This package imports
``torch``, numpy and scipy only, and never the JAX package: where it needs one of that
package's numpy-only modules it keeps its own copy.

* ``utils``     — quaternion/SE(3) transforms, part compaction, metrics, the typed config.
* ``models``    — DDPM scheduler, embeddings, the frozen VQ-VAE encoder, the denoiser and
                  verifier transformers (``nn.Module``s with the original repo's keys).
* ``ops``       — geometry ops; each TPU Pallas kernel of the inference path is a CUDA kernel
                  for Hopper under ``csrc/``, with a plain PyTorch version beside it.
* ``inference`` — the auto-agglomerative denoise-verify-merge engine and its entry point.
* ``data``      — synthetic fixtures, the test-mode dataset, the loader, part bucketing.
* ``convert``   — flax parameter trees -> torch ``state_dict``s.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
