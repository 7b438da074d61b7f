"""Frozen-encoder feature extraction for the denoise loop (port of
``puzzlefusion_plusplus_tpu/inference/sampler.py``, cached-geometry path).

Per engine iteration ``build_feature_cache`` compacts the parts and builds the
rotation-invariant FPS / ball-query indices and grouped geometry once. Per denoise step
``extract_features`` folds each part's rotation into the first layer of every SA stage
(``W_eff = R^T K_xyz``) and runs the three stages through kernel S, then conv6 and the
codebook argmin. On CPU tensors the same function runs with S's plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE, pn2_grouping_geometry
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import sa_stage_fused_cached
from puzzlefusion_plusplus_tpu_torch.utils.masking import (
    compact_parts,
    compaction_indices,
    scatter_parts,
)
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_normalize, quat_to_matrix


class FrozenEncoder:
    """The VQ-VAE encoder with eval-mode BatchNorm folded into its weights once."""

    def __init__(self, model: VQVAE):
        self.num_point = model.num_point
        self.num_dim = model.num_dim
        self.e_dim = model.embedding_dim
        self.sa_npoints = model.sa_npoints
        self.sa_nsamples = model.sa_nsamples
        self.w = model.folded_weights()

    def grouping(self, flat_pcs: torch.Tensor):
        return pn2_grouping_geometry(flat_pcs, self.num_point, self.sa_npoints,
                                     self.sa_nsamples)

    def encode(self, idx_stages, geom_stages, rot: torch.Tensor) -> dict:
        """Cached stages + per-cloud rotations [M, 3, 3] -> z_q [M, L, num_dim], xyz
        [M, L, 3], and z_e [M, L, num_dim] (the unquantized codes)."""
        (_, _), (_, gi2), (_, gi3) = idx_stages
        (_, g1), (_, g2), (n3, g3) = geom_stages

        def run(sa, g, feats, gidx):
            (k1, b1), (w2, b2), (w3, b3) = self.w[sa]
            w_eff = torch.einsum("med,ec->mdc", rot, k1[:3])  # R^T K_xyz
            k1f = k1[3:] if feats is not None else None
            return sa_stage_fused_cached(g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3)

        f1 = run("sa1", g1, None, None)
        f2 = run("sa2", g2, f1, gi2)
        f3 = run("sa3", g3, f2, gi3)
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
        xyz = torch.einsum("msd,med->mse", n3, rot)  # rotated token centres
        return {"z_q": z_q.reshape(M, self.num_point, -1), "xyz": xyz, "z_e": z_e}


class FeatureCache(NamedTuple):
    """Per-iteration invariants: compaction layout, stage indices, unrotated geometry.
    Valid while part_pcs / part_valids are unchanged (between merges)."""

    order: torch.Tensor
    src: torch.Tensor
    slot_valid: torch.Tensor
    idx_stages: tuple
    geom_stages: tuple


def build_feature_cache(encoder: FrozenEncoder, part_pcs: torch.Tensor,
                        part_valids: torch.Tensor) -> FeatureCache:
    """part_pcs [B, P, N, 3], part_valids [B, P]."""
    B, P, N, _ = part_pcs.shape
    order, src, slot_valid = compaction_indices(part_valids)
    flat = compact_parts(part_pcs, src).reshape(B * P, N, 3)
    idx_stages, geom_stages = encoder.grouping(flat)
    return FeatureCache(order, src, slot_valid, idx_stages, geom_stages)


def extract_features(encoder: FrozenEncoder, part_pcs: torch.Tensor,
                     noisy_trans_and_rots: torch.Tensor, cache: FeatureCache):
    """Encode the parts rotated by their noisy quaternions; scatter back to part order.
    -> (latent [B, P, L, num_dim], xyz [B, P, L, 3]); invalid parts are zero."""
    B, P = part_pcs.shape[:2]
    quat = quat_normalize(noisy_trans_and_rots[..., 3:])
    q_flat = compact_parts(quat, cache.src).reshape(B * P, 4)
    out = encoder.encode(cache.idx_stages, cache.geom_stages, quat_to_matrix(q_flat))
    z_q = out["z_q"].reshape(B, P, encoder.num_point, encoder.num_dim)
    xyz = out["xyz"].reshape(B, P, encoder.num_point, 3)
    return (scatter_parts(z_q, cache.order, cache.slot_valid),
            scatter_parts(xyz, cache.order, cache.slot_valid))
