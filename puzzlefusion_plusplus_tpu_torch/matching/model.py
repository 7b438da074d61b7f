"""The Jigsaw matcher: joint fracture-point segmentation and matching (port of
``puzzlefusion_plusplus_tpu/matching/model.py``).

encoder (PointNet++ MSG or DGCNN) -> PointTransformer self-attention -> cross-attention ->
fracture-point classifier (BN-ReLU-Linear) -> critical points compacted to the front ->
affinity features (BN-ReLU-Linear, each half L2-normalised) -> ``AffinityDual`` bilinear
score -> cross-piece mask -> log-space Sinkhorn. The losses: the permutation loss against
the nearest cross-piece critical point, and the rigid loss, a weighted-Horn residual per
piece pair.

Spans (``utils/profiling.py``): ``pfpp.match.encode`` (the encoder), ``pfpp.match.attention``
(``tf_self1``, ``tf_cross1``), ``pfpp.match.affinity`` (classifier, compaction, affinity head,
cross mask), ``pfpp.match.sinkhorn``.

Module and parameter names follow the flax tree (``encoder.sa1.conv0_0``, ``cls_bn``,
``affinity_layer.A``), so ``convert/from_jax.py::matching_state_dict`` maps it key by key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from puzzlefusion_plusplus_tpu_torch.matching import ops as mops
from puzzlefusion_plusplus_tpu_torch.matching.alignment import weighted_horn
from puzzlefusion_plusplus_tpu_torch.matching.encoder import DGCNN, PointNet2MSGPointwise
from puzzlefusion_plusplus_tpu_torch.matching.layers import (
    BatchNormPoints,
    CrossAttentionLayer,
    PointTransformerLayer,
)
from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import hungarian, sinkhorn_log
from puzzlefusion_plusplus_tpu_torch.models.vqvae import MaskedBatchNorm
from puzzlefusion_plusplus_tpu_torch.parallel import mesh
from puzzlefusion_plusplus_tpu_torch.utils import profiling


def lecun_normal_(linear: nn.Linear) -> None:
    """flax's Dense init: the kernel from ``lecun_normal`` (a normal of variance 1/fan_in
    truncated at two standard deviations, rescaled to keep that variance), the bias 0; a
    model trained from its init starts where the JAX package's does, not from torch's
    uniform init, whose random biases set the untrained classifier's operating point."""
    std = linear.in_features ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)


class AffinityDual(nn.Module):
    """score = X_primal @ A @ Y_dual^T over the first half of X's features and the second
    half of Y's; A starts near the identity."""

    def __init__(self, dim: int):
        super().__init__()
        hd = dim // 2
        bound = hd ** -0.5
        self.A = nn.Parameter(torch.empty(hd, hd).uniform_(-bound, bound) + torch.eye(hd))

    def forward(self, x, y):
        hd = self.A.shape[0]
        return torch.einsum("bnd,de,bme->bnm", x[..., :hd], self.A, y[..., hd:])


class JigsawModel(nn.Module):
    def __init__(self, pc_feat_dim: int = 128, aff_feat_dim: int = 512,
                 encoder_type: str = "pointnet2", tf_num_heads: int = 8,
                 tf_num_samples: int = 16, sinkhorn_iters: int = 20,
                 sinkhorn_tau: float = 0.05, sa_npoints=(1024, 256, 64, 16),
                 cls_method: str = "binary", num_classes: int = 2,
                 canonicalize_inputs: bool = False, max_num_part: int = 20):
        super().__init__()
        if encoder_type not in ("pointnet2", "dgcnn") or cls_method not in ("binary", "multi"):
            raise ValueError(f"encoder_type {encoder_type!r}, cls_method {cls_method!r}")
        self.aff_feat_dim, self.cls_method = aff_feat_dim, cls_method
        self.sinkhorn_iters, self.sinkhorn_tau = sinkhorn_iters, sinkhorn_tau
        self.canonicalize_inputs, self.max_num_part = canonicalize_inputs, max_num_part
        self.encoder = (PointNet2MSGPointwise(pc_feat_dim, sa_npoints)
                        if encoder_type == "pointnet2" else DGCNN(pc_feat_dim))
        self.tf_self1 = PointTransformerLayer(pc_feat_dim, pc_feat_dim, tf_num_heads,
                                              tf_num_samples)
        self.tf_cross1 = CrossAttentionLayer(pc_feat_dim, tf_num_heads)
        self.cls_bn = BatchNormPoints(pc_feat_dim)
        self.cls_head = nn.Linear(pc_feat_dim, 1 if cls_method == "binary" else num_classes)
        self.aff_bn = BatchNormPoints(pc_feat_dim)
        self.aff_head = nn.Linear(pc_feat_dim, aff_feat_dim)
        self.affinity_layer = AffinityDual(aff_feat_dim)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m)

    def reduce_over(self, group) -> "JigsawModel":
        """Compute the train-mode BatchNorm statistics over the batch of ``group``'s ranks
        (``parallel/mesh.py::data_group``); None: this process's batch alone."""
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.group = group
        return self

    def forward(self, part_pcs, pid, n_valid, critical_label, compute_matching: bool = True,
                use_pred_labels: bool = False) -> dict:
        """part_pcs [B, N, 3] (the augmented frame), pid [B, N] (P for padding), n_valid [B],
        critical_label [B, N] {0, 1} (ground truth in training; ``use_pred_labels`` takes the
        classifier's). BatchNorm runs in train mode when ``self.training``."""
        with profiling.span("pfpp.match.encode"):
            valid = mops.valid_point_mask(pid, n_valid)
            enc_pcs = (mops.pca_canonicalize(part_pcs, pid, valid, self.max_num_part)
                       if self.canonicalize_inputs else part_pcs)
            feats = self.encoder(enc_pcs, pid, valid)
        with profiling.span("pfpp.match.attention"):
            feats = self.tf_self1(enc_pcs, feats, pid)
            feats = self.tf_cross1(feats, valid[:, None, :] & valid[:, :, None])

        with profiling.span("pfpp.match.affinity"):
            h = torch.relu(self.cls_bn(feats, valid.float()))
            if self.cls_method == "binary":
                cls_logits = self.cls_head(h)[..., 0]
                cls_pred = (torch.sigmoid(cls_logits) > 0.5) & valid
            else:
                cls_logits = F.log_softmax(self.cls_head(h), dim=-1)
                cls_pred = (cls_logits.argmax(-1) > 0) & valid
            out = {"cls_logits": cls_logits, "cls_pred": cls_pred.to(torch.int32),
                   "part_feats": feats}
            if not compute_matching:
                return out

            labels = out["cls_pred"] if use_pred_labels else critical_label.to(torch.int32)
            labels = labels * valid.to(torch.int32)
            slot_valid, (crit_feats, crit_pid), order = mops.compact_critical(
                labels, feats, pid[..., None].float())
            crit_pid = torch.where(slot_valid, crit_pid[..., 0].to(torch.int32),
                                   n_valid[:, None].to(torch.int32))
            # the statistics over the critical slots alone (the tail holds the other points)
            a = self.aff_head(torch.relu(self.aff_bn(crit_feats, slot_valid.float())))
            hd = self.aff_feat_dim // 2
            a = torch.cat([a[..., :hd] / a[..., :hd].norm(dim=-1, keepdim=True).clamp_min(1e-12),
                           a[..., hd:] / a[..., hd:].norm(dim=-1, keepdim=True).clamp_min(1e-12)],
                          dim=-1)
            s = self.affinity_layer(a, a)
            cross = ((crit_pid[:, :, None] != crit_pid[:, None, :])
                     & slot_valid[:, :, None] & slot_valid[:, None, :])
            s = torch.where(cross, s, -1e6)
            n_crit = labels.sum(-1)
        with profiling.span("pfpp.match.sinkhorn"):
            ds_mat = sinkhorn_log(s, n_crit, n_crit, self.sinkhorn_iters, self.sinkhorn_tau)
        out.update(ds_mat=ds_mat, s_mask=cross, crit_slot_valid=slot_valid, crit_pid=crit_pid,
                   crit_order=order, n_critical_sum=n_crit)
        return out


# ------------------------------------------------------------------ losses


def gt_permutation(gt_pcs_crit: torch.Tensor, cross_mask: torch.Tensor) -> torch.Tensor:
    """The nearest cross-piece critical point as a one-hot row [B, Nc, Nc] (first of ties)."""
    d = torch.where(cross_mask, mops.square_distance(gt_pcs_crit, gt_pcs_crit), 1e6)
    perm = F.one_hot(d.argmin(-1), d.shape[-1]).float()
    return perm * cross_mask.float()


def permutation_loss(ds_mat, gt_perm, n_rows, group=None):
    """Masked BCE over the whole valid [n_r, n_r] square (same-piece zeros included), over
    the row count of ``group``'s batch (None: this process's)."""
    p = ds_mat.clamp(1e-7, 1.0 - 1e-7)
    bce = -(gt_perm * torch.log(p) + (1.0 - gt_perm) * torch.log(1.0 - p))
    row_valid = torch.arange(ds_mat.shape[1], device=ds_mat.device)[None, :] < n_rows[:, None]
    sq = row_valid[:, :, None] & row_valid[:, None, :]
    return (bce * sq).sum() / global_count(n_rows.sum().float(), group).clamp_min(1.0)


def global_count(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (no gradient); ``x`` itself where group is None."""
    return x if group is None else mesh.global_sum(x, group)


def rigid_loss_pairs(ds_mat: torch.Tensor, crit_pts: torch.Tensor, crit_pid: torch.Tensor,
                     slot_valid: torch.Tensor, max_parts: int, group=None) -> torch.Tensor:
    """The weighted-Horn alignment residual of every piece pair (i < j): piece i's critical
    points aligned onto the match-weighted positions of piece j's, the residual scaled by
    the pair's match mass, summed over the pairs and divided by the global count of
    source points of pairs with mass.

    Factored form: with A = ds + ds^T and O the slot-masked piece one-hot [Nc, P], a pair's
    row weights are O[:, i] * (A @ O)[:, j], its soft targets O[:, i] * (A @ (O pts))[:, j]
    and its mass (O^T A O)[i, j]; no [Nc, Nc] matrix a pair is built. The 190 pair
    alignments are one batched SVD under ``no_grad``: the JAX package stops their gradient
    (the reference aligns on the detached matrix), so the gradient flows through the row
    weights, the soft targets and the masses only."""
    B, Nc, _ = crit_pts.shape
    ii, jj = torch.triu_indices(max_parts, max_parts, 1, device=ds_mat.device)
    O = mops.one_hot_pieces(crit_pid, max_parts, ds_mat.dtype) * slot_valid[..., None].to(
        ds_mat.dtype)  # [B, Nc, P]
    A = ds_mat + ds_mat.transpose(1, 2)
    WW = A @ O  # [B, Nc, P]
    Z = (A @ (O[..., None] * crit_pts[:, :, None, :]).reshape(B, Nc, -1)).reshape(
        B, Nc, max_parts, 3)
    G = O.transpose(1, 2) @ WW  # [B, P, P]
    src_m = O[:, :, ii].transpose(1, 2)  # [B, Q, Nc]
    w_row = src_m * WW[:, :, jj].transpose(1, 2)  # [B, Q, Nc]
    tgt_soft = src_m[..., None] * Z[:, :, jj, :].transpose(1, 2)  # [B, Q, Nc, 3]
    pts = crit_pts[:, None].expand(-1, len(ii), -1, -1)
    with torch.no_grad():
        r, t = weighted_horn(pts, tgt_soft / w_row[..., None].clamp_min(1e-9), w_row)
    aligned = (pts @ r.transpose(-1, -2) + t[..., None, :]) * w_row[..., None]
    resid = (aligned - tgt_soft).square().sum((-1, -2))  # [B, Q]
    mat_s = G[:, ii, jj]
    counts = src_m.sum(-1).clamp_min(1.0) * (mat_s > 0)
    return (resid * mat_s).sum() / global_count(counts.sum().detach(), group).clamp_min(1.0)


def matching_f1(perm_pred, gt_perm, cross_mask) -> dict:
    tp = (perm_pred * gt_perm * cross_mask).sum()
    fp = (perm_pred * (1 - gt_perm) * cross_mask).sum()
    fn = ((1 - perm_pred) * gt_perm * cross_mask).sum()
    eps = 1e-7
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    return {"mat_precision": precision, "mat_recall": recall,
            "mat_f1": 2 * precision * recall / (precision + recall + eps)}


def hungarian_perm(ds_mat, n_crit):
    """The Hungarian assignment of each sample's critical block (host, numpy arrays)."""
    return hungarian(ds_mat, n_crit, n_crit)
