"""Frozen-encoder feature extraction and the reverse-diffusion loop (port of
``puzzlefusion_plusplus_tpu/inference/sampler.py``).

``make_frozen_encoder(model, fused)`` wraps the VQ-VAE as the denoiser's frozen encoder. Its
``apply`` dispatches as the JAX package's does:

* ``fused='cached'`` (default) with cached geometry and per-cloud rotations: each SA stage is
  one launch of kernel S over the unrotated grouped geometry, with the rotation folded into
  the first layer (``W_eff = R^T K_xyz``) — the engine's and the validation sampler's path.
* ``fused='always'`` with cached indices and no geometry: rotate-then-encode with the indices
  reused, each SA stage one launch of kernel R over the raw cloud.
* anything else: the composable encode (``VQVAE.encode``: kernels F, G and A).

The JAX package honours the fused modes on a TPU only; here each kernel wrapper picks its
kernel or its plain version by device, so every mode computes the same function on both.
Under ``trainer.precision=bf16`` the VQ-VAE computes in bf16 (``VQVAE.with_dtype``), which
reaches the composable encode only: kernels S and R take the fp32 folded weights, as the JAX
package's fused encodes do.
Kernel S's gather mode (``ops/sa_fused.py``: exact, or ``'int8'``, SA2's and SA3's projections
quantized to 8 bits) is the encoder's ``sa_gather``: ``gather_impl``, else ``PFPP_SA_GATHER``
read once when the encoder is built (the JAX package reads it when it traces the encode),
default ``'onehot'``. It reaches every caller of the cached encode: the engine, verifier
generation and the denoiser's ``train_encode_cached`` steps and validation. The 'always' and
'never' modes have no int8 mode and stay exact.
Per engine iteration ``build_feature_cache`` builds the rotation-invariant indices and
grouped geometry once; ``extract_features`` encodes per step, from the cache or (training's
single-shot encode) by rotating the clouds. ``ddpm_sample`` is the 20-step reverse loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams, step as ddpm_step
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE, pn2_grouping_geometry
from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import (
    sa_gather_mode,
    sa_stage_fused,
    sa_stage_fused_cached,
    tf32_planes,
)
from puzzlefusion_plusplus_tpu_torch.utils.masking import (
    compact_parts,
    compaction_indices,
    scatter_parts,
)
from puzzlefusion_plusplus_tpu_torch.utils.profiling import span
from puzzlefusion_plusplus_tpu_torch.utils.transforms import (
    qrot,
    quat_normalize,
    quat_to_matrix,
)

FUSED_MODES = ("cached", "always", "never")


class FrozenEncoder:
    """The VQ-VAE encoder, frozen: the module is put in eval mode with its parameters
    frozen, and eval-mode BatchNorm is folded into its weights once for kernels S and R.
    In the 'cached' mode each stage's folded W2 and W3 are also split once into their TF32
    planes (``tf32_planes``, span ``pfpp.encoder.weight_split``), which every launch of
    kernel S takes as they are. ``sa_gather`` is kernel S's gather mode, resolved here
    (module note)."""

    def __init__(self, model: VQVAE, fused: str = "cached", gather_impl: str | None = None):
        if fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {fused!r}")
        self.model = model.eval().requires_grad_(False)
        self.fused = fused
        self.sa_gather = sa_gather_mode(gather_impl)
        self.num_point = model.num_point
        self.num_dim = model.num_dim
        self.e_dim = model.embedding_dim
        self.sa_npoints = model.sa_npoints
        self.sa_nsamples = model.sa_nsamples
        self.w = model.folded_weights()
        self.planes = {}  # stage -> (W2, W3) planes
        if fused == "cached":
            with span("pfpp.encoder.weight_split"):
                for sa in ("sa1", "sa2", "sa3"):
                    (_, _), (w2, _), (w3, _) = self.w[sa]
                    self.planes[sa] = (tf32_planes(w2), tf32_planes(w3))

    def grouping(self, flat_pcs: torch.Tensor):
        return pn2_grouping_geometry(flat_pcs, self.num_point, self.sa_npoints,
                                     self.sa_nsamples)

    @torch.no_grad()
    def apply(self, flat_pcs: torch.Tensor, cached_idx=None, cached_geom=None,
              rot: torch.Tensor | None = None) -> dict:
        """flat_pcs [M, N, 3] -> z_q [M, L, num_dim], xyz [M, L, 3], z_e [M, L, num_dim],
        by the dispatch of the module note."""
        if self.fused == "always" and cached_idx is not None and cached_geom is None:
            return self.fused_encode(flat_pcs, cached_idx)
        if self.fused == "cached" and cached_geom is not None and rot is not None:
            return self.encode(cached_idx, cached_geom, rot)
        return self.model.encode(flat_pcs, cached_idx, cached_geom, rot)

    def _quantize(self, f3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """SA3 features -> (z_q, z_e) through conv6 and the codebook argmin."""
        conv6_k, conv6_b = self.w["conv6"]
        codebook = self.w["codebook"]
        z_e = f3 @ conv6_k + conv6_b  # [M, L, num_dim]
        M = z_e.shape[0]
        z = z_e.reshape(M, -1, self.e_dim)
        d = (
            (z**2).sum(-1, keepdim=True)
            + (codebook**2).sum(-1)
            - 2.0 * torch.einsum("mtc,ec->mte", z, codebook)
        )
        z_q = codebook[d.argmin(-1)]  # first minimum on ties
        return z_q.reshape(M, self.num_point, -1), z_e

    def encode(self, idx_stages, geom_stages, rot: torch.Tensor) -> dict:
        """Kernel S: cached stages + per-cloud rotations [M, 3, 3] -> z_q, xyz, z_e."""
        (_, _), (_, gi2), (_, gi3) = idx_stages
        (_, g1), (_, g2), (n3, g3) = geom_stages

        def run(sa, g, feats, gidx):
            (k1, b1), (w2, b2), (w3, b3) = self.w[sa]
            w2, w3 = self.planes.get(sa, (w2, w3))  # other modes: the wrapper splits
            w_eff = torch.einsum("med,ec->mdc", rot, k1[:3])  # R^T K_xyz
            k1f = k1[3:] if feats is not None else None
            return sa_stage_fused_cached(g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3,
                                         gather_impl=self.sa_gather)

        f1 = run("sa1", g1, None, None)
        f2 = run("sa2", g2, f1, gi2)
        f3 = run("sa3", g3, f2, gi3)
        z_q, z_e = self._quantize(f3)
        xyz = torch.einsum("msd,med->mse", n3, rot)  # rotated token centres
        return {"z_q": z_q, "xyz": xyz, "z_e": z_e}

    def fused_encode(self, flat_pcs: torch.Tensor, idx_stages) -> dict:
        """Kernel R: clouds (in their own frame) + cached stage indices -> z_q, xyz, z_e."""
        (i1, g1), (i2, g2), (i3, g3) = idx_stages
        f1 = sa_stage_fused(flat_pcs, i1, g1, self.w["sa1"])
        x1 = index_points(flat_pcs, i1)
        f2 = sa_stage_fused(torch.cat([x1, f1], -1), i2, g2, self.w["sa2"])
        x2 = index_points(x1, i2)
        f3 = sa_stage_fused(torch.cat([x2, f2], -1), i3, g3, self.w["sa3"])
        z_q, z_e = self._quantize(f3)
        return {"z_q": z_q, "xyz": index_points(x2, i3), "z_e": z_e}


def make_frozen_encoder(model: VQVAE, fused: str = "cached",
                        gather_impl: str | None = None) -> FrozenEncoder:
    """``fused`` selects the frozen encode's path: 'cached' (kernel S when cached geometry
    and rotations are given), 'always' (kernel R when cached indices and no geometry are
    given) or 'never' (always the composable encode). ``gather_impl`` is kernel S's gather
    mode; None reads ``PFPP_SA_GATHER`` now (default 'onehot')."""
    return FrozenEncoder(model, fused, gather_impl)


class FeatureCache(NamedTuple):
    """Per-iteration invariants: compaction layout, compacted unrotated clouds, stage
    indices, unrotated geometry. Valid while part_pcs / part_valids are unchanged (between
    merges)."""

    order: torch.Tensor
    src: torch.Tensor
    slot_valid: torch.Tensor
    flat: torch.Tensor  # [B * P, N, 3]
    idx_stages: tuple
    geom_stages: tuple


def build_feature_cache(encoder: FrozenEncoder, part_pcs: torch.Tensor,
                        part_valids: torch.Tensor) -> FeatureCache:
    """part_pcs [B, P, N, 3], part_valids [B, P]."""
    B, P, N, _ = part_pcs.shape
    order, src, slot_valid = compaction_indices(part_valids)
    flat = compact_parts(part_pcs, src).reshape(B * P, N, 3)
    idx_stages, geom_stages = encoder.grouping(flat)
    return FeatureCache(order, src, slot_valid, flat, idx_stages, geom_stages)


def extract_features(encoder: FrozenEncoder, part_pcs: torch.Tensor,
                     noisy_trans_and_rots: torch.Tensor, cache: FeatureCache | None = None,
                     part_valids: torch.Tensor | None = None):
    """Encode the parts rotated by their noisy quaternions; scatter back to part order.
    -> (latent [B, P, L, num_dim], xyz [B, P, L, 3]); invalid parts are zero.

    With ``cache`` (``build_feature_cache`` on the same clouds) the rotation goes into the
    encoder as matrices next to the cached geometry. Without it (the training loss's
    single-shot encode) the clouds are rotated, compacted by ``part_valids`` and encoded
    with nothing cached."""
    B, P, N, _ = part_pcs.shape
    quat = quat_normalize(noisy_trans_and_rots[..., 3:])
    if cache is None:
        if part_valids is None:
            raise ValueError("extract_features needs part_valids when no cache is given")
        order, src, slot_valid = compaction_indices(part_valids)
        rotated = qrot(quat[:, :, None, :], part_pcs)
        out = encoder.apply(compact_parts(rotated, src).reshape(B * P, N, 3))
    else:
        order, src, slot_valid = cache.order, cache.src, cache.slot_valid
        rot = quat_to_matrix(compact_parts(quat, src).reshape(B * P, 4))
        out = encoder.apply(cache.flat, cache.idx_stages, cache.geom_stages, rot)
    z_q = out["z_q"].reshape(B, P, encoder.num_point, encoder.num_dim)
    xyz = out["xyz"].reshape(B, P, encoder.num_point, 3)
    return scatter_parts(z_q, order, slot_valid), scatter_parts(xyz, order, slot_valid)


def ddpm_sample(
    denoise_fn: Callable,  # (noisy [B, P, 7], t [B]) -> predicted noise [B, P, 7]
    ddpm: DDPMParams,
    timesteps,  # [S] descending inference timesteps (ints)
    init_noisy: torch.Tensor,  # [B, P, 7]
    ref_part: torch.Tensor,  # [B, P] bool
    reference_vals: torch.Tensor,  # [B, P, 7] poses pinned for the reference parts
    generator: torch.Generator | None,
    num_inference_steps: int,
    noise_seq: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reverse loop -> (final [B, P, 7], trajectory [S, B, P, 7]). Each step's variance
    noise is drawn from ``generator``, or taken from ``noise_seq`` [S, B, P, 7] (tests
    inject the JAX package's draws that way)."""
    ref = ref_part[..., None]
    noisy = torch.where(ref, reference_vals, init_noisy)
    traj = []
    for k, t in enumerate(int(t) for t in timesteps):
        pred = denoise_fn(noisy, torch.full((noisy.shape[0],), t, dtype=torch.long,
                                            device=noisy.device))
        z = (noise_seq[k] if noise_seq is not None else
             torch.randn(noisy.shape, generator=generator, device=noisy.device))
        noisy = torch.where(ref, reference_vals,
                            ddpm_step(ddpm, pred, t, noisy, z, num_inference_steps))
        traj.append(noisy)
    return noisy, torch.stack(traj)
