"""Auto-agglomerative denoise-verify-merge engine (port of
``puzzlefusion_plusplus_tpu/inference/engine.py``), batched over shapes.

The graph lives in dense per-sample tensors with a leading batch dim: [B, P] node state,
[B, P, 4, 4] accumulated affines, a [B, P, P] merge adjacency; connected components are
min-label propagation. Every phase works on the whole batch at once (``vmap`` written out).
Two things need the host once per iteration: the batch-global merge gate (the merge
geometry runs only when some sample merges) and the early exit once every sample is done.

Noise: the JAX engine draws per-part normals from ``jax.random`` keys. Here
``auto_agglomerate_batch`` takes ``noise=(init [B, P, 7], steps [max_iters*S, B, P, 7])`` or
draws it from a ``torch.Generator`` at ``cfg.noise_parts`` parts and slices to the pad P, so
that part i's noise does not depend on the pad (part-count bucketing stays exact).
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.inference.sampler import (
    FrozenEncoder,
    build_feature_cache,
    extract_features,
)
from puzzlefusion_plusplus_tpu_torch.models.scheduler import (
    DDPMParams,
    leading_timesteps,
    step as ddpm_step,
)
from puzzlefusion_plusplus_tpu_torch.ops.chamfer import masked_pairwise_nn
from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample_per_cloud
from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points
from puzzlefusion_plusplus_tpu_torch.ops.normals import estimate_pointcloud_normals
from puzzlefusion_plusplus_tpu_torch.utils import profiling
from puzzlefusion_plusplus_tpu_torch.utils.transforms import (
    affine_to_pose,
    pose_to_affine,
    qrot,
    quat_apply_raw,
    quat_normalize,
)

CD_BIN_EDGES = (0.0, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 100.0)
MATCHING_KEYS = ("match_edges", "match_edge_valid", "corr_src", "corr_tgt", "corr_count")


class AgglConfig(NamedTuple):
    max_iters: int = 6
    num_inference_steps: int = 20
    threshold: float = 0.9
    scale_cutoff: float = 0.05  # "larger parts" cutoff
    intersect_threshold: float = 1e-3  # interpenetration CD cutoff
    normals_k: int = 20
    normals_method: str = "analytic"  # 'lowmem' at large batch (run.py)
    noise_parts: int = 20  # parts the noise is drawn at (cfg.data.max_num_part)


class AgglState(NamedTuple):
    noisy: torch.Tensor  # [B, P, 7]
    reference_vals: torch.Tensor  # [B, P, 7] pinned poses of ref parts
    ref_part: torch.Tensor  # [B, P] bool
    part_valids: torch.Tensor  # [B, P] f32
    part_scale: torch.Tensor  # [B, P] f32
    part_pcs: torch.Tensor  # [B, P, N, 3] (mutated by merges)
    area_pts: torch.Tensor  # [B, P, A, 3] (mutated by merges)
    pivot: torch.Tensor  # [B, P] int64
    node_valids: torch.Tensor  # [B, P] bool
    init_pose: torch.Tensor  # [B, P, 4, 4]
    classified: torch.Tensor  # [B, P] bool
    adj: torch.Tensor  # [B, P, P] bool accumulated merge graph
    done: torch.Tensor  # [B] bool


class MergeCtx(NamedTuple):
    """What the merge geometry and commit need from the verify pass."""

    transformed_pts: torch.Tensor  # [B, P, N, 3] world-pose clouds
    labels: torch.Tensor  # [B, P] component labels
    label_pivot: torch.Tensor  # [B, P] largest-scale valid member per label
    centroid: torch.Tensor  # [B, P, 3] per-label member centroid
    merging: torch.Tensor  # [B, P] bool per label
    part_merges: torch.Tensor  # [B, P] bool per part
    classified: torch.Tensor  # [B, P] bool (post-verify, pre-merge)
    larger: torch.Tensor  # [B, P] bool
    done: torch.Tensor  # [B] bool (after the pre-merge early-stop check)


def triu_indices(P: int, device=None) -> torch.Tensor:
    """[P(P-1)/2, 2] upper-triangle pairs in row-major order."""
    pairs = list(itertools.combinations(range(P), 2))
    return torch.tensor(np.asarray(pairs, np.int64).reshape(-1, 2), device=device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-sample gather along dim 1: x [B, P, ...], idx [B, Q] -> [B, Q, ...]."""
    idx = idx.long()
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def compose_poses(noisy: torch.Tensor, pivot: torch.Tensor, init_pose: torch.Tensor):
    """Node i's final pose = affine(pose of pivot[i]) @ init_pose[i] -> (trans, quat)."""
    aff = pose_to_affine(_take(noisy[..., :3], pivot), _take(noisy[..., 3:], pivot))
    return affine_to_pose(aff @ init_pose)


def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Min-label propagation: adj [B, P, P] bool -> labels [B, P] (min member index)."""
    P = adj.shape[-1]
    a = adj | torch.eye(P, dtype=torch.bool, device=adj.device)
    labels = torch.arange(P, device=adj.device).expand(adj.shape[:-1]).clone()
    for _ in range(P):
        neigh = torch.where(a, labels[..., None, :], torch.full_like(labels[..., None, :], P))
        labels = torch.minimum(labels, neigh.amin(-1))
    return labels


def edge_histograms(area_world, match_edges, match_edge_valid, corr_src, corr_tgt,
                    corr_count, P: int) -> torch.Tensor:
    """Per-edge matched-point CD histogram scattered into a [B, P, P, 6] grid at
    [idx1, idx2]; where edges repeat a cell, the last edge in order wins (invalid edges
    write zeros), as the reference's loop does."""
    B, E, K = corr_src.shape
    idx2 = match_edges[..., 0].long()
    idx1 = match_edges[..., 1].long()
    kmask = torch.arange(K, device=corr_src.device) < corr_count[..., None]  # [B, E, K]
    b_ix = torch.arange(B, device=corr_src.device)[:, None, None]
    src = area_world[b_ix, idx1[..., None], corr_src.long()]  # [B, E, K, 3]
    tgt = area_world[b_ix, idx2[..., None], corr_tgt.long()]
    big = torch.full((), 1e6, dtype=src.dtype, device=src.device)
    src = torch.where(kmask[..., None], src, big)  # invalid slots fall out of every bin
    tgt = torch.where(kmask[..., None], tgt, -big)

    d = sum((src[:, :, :, None, c] - tgt[:, :, None, :, c]) ** 2 for c in range(3))
    per_point = d.amin(3) + d.amin(2)  # index-aligned fwd + bwd
    edges = torch.tensor(CD_BIN_EDGES, dtype=d.dtype, device=d.device)
    bin_idx = (per_point[..., None] > edges).sum(-1)  # bucketize(right=True)
    in_bin = (bin_idx[..., None] == 1 + torch.arange(6, device=d.device)) & kmask[..., None]
    bins = in_bin.sum(2).to(d.dtype)
    bins = torch.where(match_edge_valid[..., None].bool(), bins, torch.zeros_like(bins))

    cell = idx1 * P + idx2  # [B, E]
    pos = torch.arange(E, device=cell.device).expand(B, E)
    last = torch.full((B, P * P), -1, dtype=torch.long, device=cell.device)
    last = last.scatter_reduce(1, cell, pos, reduce="amax", include_self=True)
    grid = _take(bins, last.clamp_min(0))
    grid = torch.where((last >= 0)[..., None], grid, torch.zeros_like(grid))
    return grid.reshape(B, P, P, 6)


def interpenetration_keep_mask(transformed_pts, normals, pair_active, threshold: float):
    """Per part i, drop point n if for some active pair (i, j) the index-aligned
    bidirectional per-point CD is under ``threshold`` and the index-aligned normal dot is
    negative. ``pair_active`` [B, P, P] must be symmetric. -> keep [B, P, N] bool."""
    nn_fwd = masked_pairwise_nn(transformed_pts, pair_active)  # [B, i, j, N]
    per_point = nn_fwd + nn_fwd.transpose(1, 2)
    ndot = torch.einsum("bind,bjnd->bijn", normals, normals)
    remove = (per_point < threshold) & (ndot < 0) & pair_active[..., None]
    return ~remove.any(dim=2)


def make_init_state(batch: dict, noise_init: torch.Tensor) -> AgglState:
    """Noise every pose, pin the reference part to GT, identity graph state."""
    B, P = batch["part_valids"].shape
    dev = noise_init.device
    gt = torch.cat([batch["part_trans"], batch["part_rots"]], dim=-1)
    ref0 = batch["ref_part"].bool()
    return AgglState(
        noisy=torch.where(ref0[..., None], gt, noise_init.to(gt.dtype)),
        reference_vals=torch.where(ref0[..., None], gt, torch.zeros_like(gt)),
        ref_part=ref0,
        part_valids=batch["part_valids"].float(),
        part_scale=batch["part_scale"][..., 0],
        part_pcs=batch["part_pcs"],
        area_pts=batch["area_pts"],
        pivot=torch.arange(P, device=dev).expand(B, P).clone(),
        node_valids=torch.ones((B, P), dtype=torch.bool, device=dev),
        init_pose=torch.eye(4, device=dev).expand(B, P, 4, 4).clone(),
        classified=torch.zeros((B, P), dtype=torch.bool, device=dev),
        adj=torch.zeros((B, P, P), dtype=torch.bool, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
    )


def denoise_phase(state: AgglState, denoiser: Callable, encoder: FrozenEncoder,
                  ddpm: DDPMParams, cfg: AgglConfig, step_noise: torch.Tensor):
    """The reverse loop of one iteration -> (state, trajectory [B, S, P, 7] of composed
    poses). ``step_noise`` [S, B, P, 7]. The grouping cache is built once: rotation leaves
    it unchanged and part_pcs/valids change only at merges."""
    B = state.noisy.shape[0]
    with profiling.span("pfpp.engine.cache"):
        cache = build_feature_cache(encoder, state.part_pcs, state.part_valids)
    noisy = state.noisy
    traj = []
    for k, t in enumerate(leading_timesteps(ddpm.num_train_timesteps,
                                            cfg.num_inference_steps).tolist()):
        with profiling.span("pfpp.engine.step"):
            with profiling.span("pfpp.engine.encode"):
                latent, xyz = extract_features(encoder, state.part_pcs, noisy, cache)
            with profiling.span("pfpp.engine.denoiser"):
                pred = denoiser(
                    noisy, torch.full((B,), t, dtype=torch.long, device=noisy.device), latent,
                    xyz, state.part_valids, state.part_scale[..., None], state.ref_part,
                )
            new = ddpm_step(ddpm, pred, t, noisy, step_noise[k], cfg.num_inference_steps)
            new = torch.where(state.ref_part[..., None], state.reference_vals, new)
            new = torch.where(state.done[:, None, None], noisy, new)  # frozen once done
            traj.append(torch.cat(compose_poses(new, state.pivot, state.init_pose), dim=-1))
            noisy = new
    return state._replace(noisy=noisy), torch.stack(traj, dim=1)


def verify_phase(state: AgglState, verifier: Callable, matching: dict,
                 num_parts: torch.Tensor, cfg: AgglConfig, triu: torch.Tensor):
    """Verifier forward + graph bookkeeping (everything but the merged-cloud geometry).
    -> (partially updated state, MergeCtx)."""
    B, P, N, _ = state.part_pcs.shape
    dev = state.noisy.device
    trans, quat_raw = state.noisy[..., :3], state.noisy[..., 3:]
    quat = quat_normalize(quat_raw)
    pts = state.part_pcs * state.part_scale[..., None, None]
    transformed_pts = qrot(quat[:, :, None, :], pts) + trans[:, :, None, :]

    # area clouds through each node's pivot with RAW quaternions, as the reference does
    piv_q, piv_t = _take(quat_raw, state.pivot), _take(trans, state.pivot)
    area_world = quat_apply_raw(piv_q[:, :, None, :], state.area_pts) + piv_t[:, :, None, :]

    ref_before = state.ref_part
    classified = state.classified | ref_before
    larger = (state.part_valids > 0) & (state.part_scale > cfg.scale_cutoff)

    grid = edge_histograms(area_world, *(matching[k] for k in MATCHING_KEYS), P)
    a, b = triu[:, 0], triu[:, 1]
    feats = grid[:, a, b]  # [B, Et, 6]
    counts = feats.sum(-1, keepdim=True)
    feats = torch.cat([feats / torch.where(counts == 0, torch.ones_like(counts), counts),
                       counts], dim=-1)
    edge_valids = (a[None] < num_parts[:, None]) & (b[None] < num_parts[:, None])
    logits = verifier(feats, triu[None].expand(B, -1, -1), edge_valids.float())[..., 0]
    pred_edge = (torch.sigmoid(logits) > cfg.threshold) & edge_valids

    # reference-part promotion: predicted edges with exactly one endpoint in the ref set
    one_ref = pred_edge & (ref_before[:, a] ^ ref_before[:, b])
    hits = torch.zeros((B, P), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, a.expand(B, -1), (one_ref & ~ref_before[:, a]).int())
    hits.scatter_add_(1, b.expand(B, -1), (one_ref & ~ref_before[:, b]).int())
    ref_part = ref_before | (hits > 0)

    # merge candidates: neither endpoint ref, neither endpoint's pivot ref
    mergeable = (
        pred_edge & ~ref_part[:, a] & ~ref_part[:, b]
        & ~_take(ref_part, state.pivot[:, a]) & ~_take(ref_part, state.pivot[:, b])
    )
    done = state.done | (classified == larger).all(-1)  # early stop BEFORE merging
    grow = mergeable & ~done[:, None]
    adj = state.adj.clone()
    adj[:, a, b] |= grow
    adj[:, b, a] |= grow
    labels = connected_components(adj)

    # per-component merge, vectorized over all P candidate labels
    ar = torch.arange(P, device=dev)
    member_valid = (labels[:, None, :] == ar[None, :, None]) & state.node_valids[:, None, :]
    merging = member_valid.sum(-1) >= 2
    part_merges = _take(merging, labels) & ~done[:, None]
    # pivot: largest-scale member among CURRENT nodes (absorbed slots keep stale scales)
    neg_inf = torch.full((), float("-inf"), device=dev)
    label_pivot = torch.where(member_valid, state.part_scale[:, None, :], neg_inf).argmax(-1)
    w = member_valid.to(transformed_pts.dtype)
    centroid = torch.einsum("blp,bpnd->bld", w, transformed_pts) / (
        (w * N).sum(-1).clamp_min(1.0)[..., None]
    )

    cent_lab = _take(centroid, labels)  # [B, P, 3]
    aff = pose_to_affine(piv_t, piv_q)
    aff[..., :3, 3] -= cent_lab
    init_pose = torch.where(part_merges[..., None, None], aff @ state.init_pose,
                            state.init_pose)
    area_pts = torch.where(part_merges[..., None, None], area_world - cent_lab[:, :, None, :],
                           state.area_pts)

    mid = state._replace(reference_vals=state.noisy, ref_part=ref_part, area_pts=area_pts,
                         init_pose=init_pose, adj=adj)
    ctx = MergeCtx(transformed_pts, labels, label_pivot, centroid, merging, part_merges,
                   classified, larger, done)
    return mid, ctx


def merge_geometry(ctx: MergeCtx, node_valids: torch.Tensor, cfg: AgglConfig):
    """Interpenetration filter + masked FPS resample of every merging component back to N
    points. -> (merged [B, P, N, 3], merge_scale [B, P]) indexed by component label."""
    B, P, N, _ = ctx.transformed_pts.shape
    dev = node_valids.device
    labels, pm, merging = ctx.labels, ctx.part_merges, ctx.merging
    member = labels[:, None, :] == torch.arange(P, device=dev)[None, :, None]

    normals = estimate_pointcloud_normals(
        ctx.transformed_pts.reshape(B * P, N, 3), cfg.normals_k, method=cfg.normals_method
    ).reshape(B, P, N, 3)
    pair_active = (
        (labels[:, :, None] == labels[:, None, :])
        & node_valids[:, :, None] & node_valids[:, None, :]
        & ~torch.eye(P, dtype=torch.bool, device=dev)
        & pm[:, :, None] & pm[:, None, :]
    )
    keep = interpenetration_keep_mask(ctx.transformed_pts, normals, pair_active,
                                      cfg.intersect_threshold)

    # a merging component consumes >= 2 valid nodes, so at most P//2 labels merge: sample
    # them in K = P//2 slots, merging labels first
    K = max(P // 2, 1)
    sel = torch.argsort((~merging).int(), dim=-1, stable=True)[:, :K]  # [B, K]
    sel_valid = _take(merging, sel)
    flat_pts = ctx.transformed_pts.reshape(B, P * N, 3)
    fps_mask = (_take(member, sel)[..., None] & node_valids[:, None, :, None]
                & keep[:, None]).reshape(B, K, P * N) & sel_valid[..., None]
    # few clouds of many points: kernel P keeps each one resident on chip
    fps_idx = farthest_point_sample_per_cloud(
        flat_pts[:, None].expand(B, K, P * N, 3).reshape(B * K, P * N, 3), N,
        mask=fps_mask.reshape(B * K, P * N),
    ).reshape(B, K * N)
    merged_k = index_points(flat_pts, fps_idx).reshape(B, K, N, 3)
    merged_k = merged_k - _take(ctx.centroid, sel)[:, :, None, :]
    scale_k = merged_k.abs().amax(dim=(2, 3))
    merged_k = merged_k / scale_k.clamp_min(1e-12)[..., None, None]
    merged_k = torch.where(sel_valid[..., None, None], merged_k, torch.zeros_like(merged_k))
    merged = torch.zeros_like(ctx.transformed_pts).scatter(
        1, sel[..., None, None].expand(B, K, N, 3), merged_k
    )
    merge_scale = torch.zeros((B, P), dtype=scale_k.dtype, device=dev).scatter(
        1, sel, torch.where(sel_valid, scale_k, torch.zeros_like(scale_k))
    )
    return merged, merge_scale


def commit_merge(orig: AgglState, mid: AgglState, ctx: MergeCtx, merged: torch.Tensor,
                 merge_scale: torch.Tensor) -> AgglState:
    """Commit merged clouds at each merging label's pivot part; samples that were already
    done before this verify pass keep their state unchanged."""
    P = ctx.labels.shape[1]
    labels, pm = ctx.labels, ctx.part_merges
    new_pivot = _take(ctx.label_pivot, labels)
    is_new_pivot = pm & (new_pivot == torch.arange(P, device=labels.device))
    part_valids = torch.where(pm, torch.zeros_like(mid.part_valids), mid.part_valids)
    classified = ctx.classified | pm
    new = mid._replace(
        part_pcs=torch.where(is_new_pivot[..., None, None], _take(merged, labels),
                             mid.part_pcs),
        part_scale=torch.where(is_new_pivot, _take(merge_scale, labels), mid.part_scale),
        part_valids=torch.where(is_new_pivot, torch.ones_like(part_valids), part_valids),
        node_valids=torch.where(pm, is_new_pivot, mid.node_valids),
        pivot=torch.where(pm, new_pivot, mid.pivot),
        classified=classified,
        done=ctx.done | (classified == ctx.larger).all(-1),
    )
    frozen = orig.done

    def keep_if_done(o, n):
        if o is n:
            return n
        return torch.where(frozen.reshape((-1,) + (1,) * (n.dim() - 1)), o, n)

    return AgglState(*(keep_if_done(o, n) for o, n in zip(orig, new)))


def verify_and_merge(state: AgglState, verifier: Callable, matching: dict,
                     num_parts: torch.Tensor, cfg: AgglConfig, triu: torch.Tensor):
    """One verify/merge pass; the merge geometry runs only if some sample merges (one host
    sync)."""
    with profiling.span("pfpp.engine.verify"):
        mid, ctx = verify_phase(state, verifier, matching, num_parts, cfg, triu)
        if profiling.sync("pfpp.sync.merge_gate", ctx.part_merges.any()):
            with profiling.span("pfpp.engine.merge"):
                merged, merge_scale = merge_geometry(ctx, mid.node_valids, cfg)
        else:
            merged = torch.zeros_like(ctx.transformed_pts)
            merge_scale = torch.zeros_like(mid.part_scale)
        return commit_merge(state, mid, ctx, merged, merge_scale)


def draw_noise(cfg: AgglConfig, B: int, P: int, generator: torch.Generator,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(init [B, P, 7], steps [max_iters*S, B, P, 7]) standard normals, drawn at
    ``cfg.noise_parts`` parts and sliced to P so part i's draw is pad-independent."""
    Pn = max(P, cfg.noise_parts)
    S = cfg.max_iters * cfg.num_inference_steps
    init = torch.randn((B, Pn, 7), generator=generator, device=device)
    steps = torch.randn((S, B, Pn, 7), generator=generator, device=device)
    return init[:, :P].contiguous(), steps[:, :, :P].contiguous()


def auto_agglomerate_batch(
    denoiser: Callable,
    verifier: Callable,
    encoder: FrozenEncoder,
    ddpm: DDPMParams,
    batch: dict,  # tensors of test-mode samples, leading dim B
    cfg: AgglConfig,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    all_done: Callable[[bool], bool] = bool,
) -> dict:
    """Full denoise-verify-merge loop over a batch; exits once every sample is done.
    Trajectory rows past an early exit repeat the final pose. ``all_done`` turns "every
    sample of this batch is done" into the exit condition; a data-parallel caller makes it
    "on every rank" (``parallel/mesh.py::all_ranks``), so that ``n_iters`` is the global
    batch's, as the JAX engine's is over a sharded batch."""
    B, P = batch["part_valids"].shape
    dev = batch["part_pcs"].device
    if noise is None:
        noise = draw_noise(cfg, B, P, generator, dev)
    noise_init, noise_steps = noise
    state = make_init_state(batch, noise_init)
    matching = {k: batch[k] for k in MATCHING_KEYS}
    num_parts = batch["num_parts"].long()
    triu = triu_indices(P, dev)
    S = cfg.num_inference_steps
    traj_buf = torch.zeros((B, cfg.max_iters * S, P, 7), dtype=state.noisy.dtype, device=dev)

    it = 0
    while it < cfg.max_iters and not all_done(profiling.sync("pfpp.sync.exit",
                                                             state.done.all())):
        state, traj = denoise_phase(state, denoiser, encoder, ddpm, cfg,
                                    noise_steps[it * S : (it + 1) * S])
        traj_buf[:, it * S : (it + 1) * S] = traj
        if it + 1 < cfg.max_iters:  # the last iteration skips verify/merge
            state = verify_and_merge(state, verifier, matching, num_parts, cfg, triu)
        it += 1

    final_trans, final_rots = compose_poses(state.noisy, state.pivot, state.init_pose)
    final_pose = torch.cat([final_trans, final_rots], dim=-1)
    recorded = torch.arange(cfg.max_iters * S, device=dev) < it * S
    traj_buf = torch.where(recorded[None, :, None, None], traj_buf, final_pose[:, None])
    return {
        "pred_trans": final_trans,
        "pred_rots": final_rots,
        "trajectory": traj_buf,  # [B, max_iters*S, P, 7]
        "final_state": state,
        "n_iters": it,
    }


def auto_agglomerate(
    denoiser: Callable,
    verifier: Callable,
    encoder: FrozenEncoder,
    ddpm: DDPMParams,
    sample: dict,  # tensors of one test-mode sample, no batch dim
    cfg: AgglConfig,
    noise: tuple[torch.Tensor, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """The denoise-verify-merge loop for one shape (the JAX package's per-shape entry):
    ``auto_agglomerate_batch`` at B = 1, its results without the batch dim. ``noise``:
    (init [P, 7], steps [max_iters*S, P, 7])."""
    batch = {k: v[None] for k, v in sample.items()}
    if noise is not None:
        noise = (noise[0][None], noise[1][:, None])
    out = auto_agglomerate_batch(denoiser, verifier, encoder, ddpm, batch, cfg, noise=noise,
                                 generator=generator)
    return {
        "pred_trans": out["pred_trans"][0],
        "pred_rots": out["pred_rots"][0],
        "trajectory": out["trajectory"][0],  # [max_iters*S, P, 7]
        "final_state": AgglState(*(f[0] for f in out["final_state"])),
    }
