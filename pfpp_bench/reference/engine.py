"""Plain reference of the auto-agglomerative engine, for the serving cells' check.

``follow`` runs the denoise-verify loop of one engine call. Given the program's per-step
record of the call (the pose state each denoising step started from, the verifier's logits
of each verify pass), it computes each step again from the state the program's step started
from, and reports how far the program's next state lies from the reference's: a one-step
comparison, so that float32 rounding does not compound over 120 steps. The first step starts
from the reference's own initial state, so the initial state is checked too. Without a
record it runs free and returns one, in the record's layout, with the trajectory of composed
poses that the program's engine returns; ``free_gaps`` compares two such runs over every
step. The control is the reference, in TF32, run free in the program's place.

It computes the grouping (FPS, ball query), the frozen encoder and its codes, the denoiser,
the DDPM step with the pinned reference parts, the edges' chamfer histograms, the verifier,
and ``part_acc`` of the final poses. The reference-part promotion and the early exit are
written out, but the seeded weights keep every logit far below the threshold
(``params.py``): no edge passes, so neither is reached, every call runs all its iterations,
and the check does not cover them. It raises ``MergeFired`` where an edge would merge two
parts: the merge path is not part of the reference.
"""

from __future__ import annotations

import itertools
import math

import torch

from pfpp_bench.reference import model as R
from pfpp_bench.reference.numerics import FP32, Precision

CD_BIN_EDGES = (0.0, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 100.0)
SCALE_CUTOFF = 0.05
PART_ACC_CD = 0.01


class MergeFired(RuntimeError):
    """An edge between two non-reference parts passed the verifier's threshold."""


def edge_histograms(area_world, match_edges, match_edge_valid, corr_src, corr_tgt, corr_count,
                    P: int):
    """Each matched edge's bidirectional per-point CD histogram (6 bins), in a [B, P, P, 6]
    grid at [edge[1], edge[0]]; a later edge overwrites an earlier one in the same cell."""
    B, E, K = corr_src.shape
    out = torch.zeros((B, P, P, 6), device=area_world.device)
    edges_t = torch.tensor(CD_BIN_EDGES, device=area_world.device)
    for b in range(B):
        for e in torch.nonzero(match_edge_valid[b]).flatten().tolist():
            j, i = match_edges[b, e].tolist()
            k = int(corr_count[b, e])
            src = area_world[b, i, corr_src[b, e, :k].long()]
            tgt = area_world[b, j, corr_tgt[b, e, :k].long()]
            d = _sq_dist(src[:, None, :], tgt[None, :, :])
            per_point = d.amin(1) + d.amin(0)
            bins = (per_point[:, None] > edges_t).sum(-1)
            out[b, i, j] = (bins[:, None] == 1 + torch.arange(6, device=d.device)).sum(0).float()
    return out


def _sq_dist(a, b):
    """(dx dx + dy dy) + dz dz, broadcast."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def chamfer_mean(x, y):
    """Mean squared NN distance both ways: [B, N, 3] x2 -> [B]."""
    d = _sq_dist(x[:, :, None, :], y[:, None, :, :])
    return d.amin(2).mean(-1) + d.amin(1).mean(-1)


def part_acc(part_pcs, scale, valids, trans, quat, gt_trans, gt_quat):
    """Share of each shape's valid parts whose posed cloud lies within CD 0.01 of its GT."""
    B, P, N, _ = part_pcs.shape
    pts = (part_pcs * scale[..., None]).reshape(B * P, N, 3)

    def posed(t, q):
        q = q.reshape(B * P, 1, 4)
        return R.quat_apply(q, pts) + t.reshape(B * P, 1, 3)

    cd = torch.cat([chamfer_mean(a, b) for a, b in zip(posed(trans, quat).split(32),
                                                       posed(gt_trans, gt_quat).split(32))])
    ok = (cd.reshape(B, P) < PART_ACC_CD) & (valids == 1)
    return ok.sum(-1) / (valids == 1).sum(-1)


def _gap(a, b, mask):
    """Largest |a - b| over the masked parts [B, P]."""
    d = (a - b).abs().amax(-1)
    return float(torch.where(mask, d, torch.zeros_like(d)).max())


def _quat_gap(a, b, mask):
    """Largest distance between unit quaternions up to sign."""
    a, b = R.quat_normalize(a), R.quat_normalize(b)
    d = torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1))
    return float(torch.where(mask, d, torch.zeros_like(d)).max())


def _composed(x):
    """Poses as the engine returns them with no merge: translation, unit quaternion."""
    return torch.cat([x[..., :3], R.quat_normalize(x[..., 3:])], -1)


def free_gaps(run: dict, prog: dict, batch: dict, steps: int | None = None) -> dict:
    """Two free runs of one call, the reference's ``run`` and the program's record ``prog``
    (the engine's trajectory [B, T, P, 7] of composed poses, ``part_acc``, ``n_iters``): the
    largest pose gap over the first ``steps`` steps (all by default) and the valid parts
    (quaternions up to sign), the same over each block of ``steps`` (``by_block``), and the
    mismatches: the iteration counts, and ``part_acc`` against the reference's of the
    program's final poses (free runs drift apart over many steps, so not of its own)."""
    a, b = run["traj"], prog["traj"]
    steps = steps or a.shape[1]
    valids = batch["part_valids"].float()
    mask = (valids > 0)[:, None].expand(a.shape[:3])
    d = torch.maximum((a[..., :3] - b[..., :3]).abs().amax(-1),
                      torch.minimum((a[..., 3:] - b[..., 3:]).abs().amax(-1),
                                    (a[..., 3:] + b[..., 3:]).abs().amax(-1)))
    d = torch.where(mask, d, torch.zeros_like(d)).amax((0, 2))  # [T]
    blocks = [float(d[k:k + steps].max()) for k in range(0, len(d), steps)]
    fin = prog["final"]
    acc = part_acc(batch["part_pcs"], batch["part_scale"], valids, fin[..., :3], fin[..., 3:],
                   batch["part_trans"], batch["part_rots"])
    mismatch = int((acc != prog["part_acc"]).sum()) + int(run["n_iters"] != prog["n_iters"])
    return {"pose": blocks[0], "by_block": blocks, "mismatch": mismatch}


@torch.no_grad()
def follow(params: dict, cfg: dict, batch: dict, noise, record: dict | None = None,
           prec: Precision = FP32) -> dict:
    """One engine call on ``batch`` (tensors on one device) with ``noise`` = (init [B, P, 7],
    steps [iters * S, B, P, 7]). With ``record`` -> the gaps; without -> a record."""
    vq, den, ver = params["vqvae"], params["denoiser"], params["verifier"]
    ec, dc, vc, loop = cfg["vqvae"], cfg["denoiser"], cfg["verifier"], cfg["engine"]
    S, iters, thr = loop["num_inference_steps"], loop["max_iters"], loop["threshold"]
    thr_logit = math.log(thr / (1.0 - thr))
    ddpm = R.DDPM(dc["ddpm_train_steps"])
    ts = ddpm.timesteps(S)

    valids = batch["part_valids"].float()
    B, P = valids.shape
    dev = valids.device
    vmask = valids > 0
    scale = batch["part_scale"][..., 0]
    gt = torch.cat([batch["part_trans"], batch["part_rots"]], -1)
    ref = batch["ref_part"].bool()
    init, steps = noise
    x = torch.where(ref[..., None], gt, init)
    reference_vals = torch.where(ref[..., None], gt, torch.zeros_like(gt))
    classified = torch.zeros((B, P), dtype=torch.bool, device=dev)
    larger = vmask & (scale > SCALE_CUTOFF)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    num_parts = batch["num_parts"].long()
    pairs = torch.tensor(list(itertools.combinations(range(P), 2)), device=dev).reshape(-1, 2)
    a, b = pairs[:, 0], pairs[:, 1]
    edge_valids = (a[None] < num_parts[:, None]) & (b[None] < num_parts[:, None])
    stages = R.iteration_grouping(ec, batch["part_pcs"], valids, prec)

    gaps = {"pose": 0.0, "logit": 0.0, "mismatch": 0}
    xs, logits_all, posed = [], [], []
    it = 0
    while it < iters and not bool(done.all()):
        for k, t in enumerate(ts):
            idx = it * S + k
            if record is not None:
                prog_x = record["x"][idx]
                gaps["pose"] = max(gaps["pose"], _gap(x, prog_x, vmask))
                x = prog_x
            xs.append(x)
            quat = R.quat_normalize(x[..., 3:])
            latent, xyz = R.features(vq, ec, batch["part_pcs"], valids, quat, stages, prec)
            eps = R.denoiser(den, dc, x, torch.full((B,), t, dtype=torch.long, device=dev),
                             latent, xyz, valids, batch["part_scale"], ref, prec=prec)
            new = ddpm.step(eps, t, x, steps[idx], S)
            new = torch.where(ref[..., None], reference_vals, new)
            x = torch.where(done[:, None, None], x, new)
            if record is None:
                posed.append(_composed(x))
        if it + 1 < iters:  # the last iteration has no verify pass
            # the verify pass reads the program's state where the record holds it (the next
            # iteration's first step starts from it), so its histograms see the same poses
            nxt = (it + 1) * S
            xv = record["x"][nxt] if record is not None and nxt < len(record["x"]) else x
            trans, q_raw = xv[..., :3], xv[..., 3:]
            area = R.quat_apply_raw(q_raw[:, :, None, :], batch["area_pts"]) + trans[:, :, None]
            grid = edge_histograms(area, batch["match_edges"], batch["match_edge_valid"],
                                   batch["corr_src"], batch["corr_tgt"], batch["corr_count"], P)
            feats = grid[:, a, b]
            counts = feats.sum(-1, keepdim=True)
            feats = torch.cat([feats / torch.where(counts == 0, torch.ones_like(counts), counts),
                               counts], -1)
            logits = R.verifier(ver, vc, feats, pairs[None].expand(B, -1, -1),
                                edge_valids.float(), prec)
            pred = (torch.sigmoid(logits) > thr) & edge_valids
            if record is not None:
                prog_l = record["logits"][it]
                gaps["logit"] = max(gaps["logit"], float(
                    torch.where(edge_valids, (logits - prog_l).abs(), torch.zeros_like(logits)).max()))
                # an edge within the tolerance of the threshold takes the program's decision
                near = (logits - thr_logit).abs() <= loop["logit_tolerance"]
                prog_pred = (torch.sigmoid(prog_l) > thr) & edge_valids
                gaps["mismatch"] += int((pred != prog_pred)[~near].sum())
                pred = torch.where(near, prog_pred, pred)
            logits_all.append(logits)
            one_ref = pred & (ref[:, a] ^ ref[:, b])
            hits = torch.zeros((B, P), dtype=torch.int32, device=dev)
            hits.scatter_add_(1, a.expand(B, -1), (one_ref & ~ref[:, a]).int())
            hits.scatter_add_(1, b.expand(B, -1), (one_ref & ~ref[:, b]).int())
            new_ref = ref | (hits > 0)
            cls = classified | ref
            new_done = done | (cls == larger).all(-1)
            if (pred & ~new_ref[:, a] & ~new_ref[:, b] & ~new_done[:, None]).any():
                raise MergeFired("an edge between two non-reference parts passed the threshold")
            keep = done[:, None]
            reference_vals = torch.where(keep[..., None], reference_vals, xv)
            ref = torch.where(keep, ref, new_ref)
            classified = torch.where(keep, classified, cls)
            done = new_done
        it += 1

    trans, quat = x[..., :3], x[..., 3:]
    if record is None:
        final = _composed(x)
        acc = part_acc(batch["part_pcs"], batch["part_scale"], valids, trans, final[..., 3:],
                       batch["part_trans"], batch["part_rots"])
        posed += [final] * (iters * S - len(posed))  # rows past an early exit: the final pose
        return {"x": torch.stack(xs), "logits": logits_all, "final": final,
                "traj": torch.stack(posed, 1), "part_acc": acc, "n_iters": it}
    fin = record["final"]
    gaps["pose"] = max(gaps["pose"], _gap(trans, fin[..., :3], vmask),
                       _quat_gap(quat, fin[..., 3:], vmask))
    acc = part_acc(batch["part_pcs"], batch["part_scale"], valids, fin[..., :3], fin[..., 3:],
                   batch["part_trans"], batch["part_rots"])
    gaps["mismatch"] += int((acc != record["part_acc"]).sum()) + int(it != record["n_iters"])
    gaps["steps"] = len(xs)
    return gaps

