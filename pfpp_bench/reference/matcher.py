"""Plain PyTorch reference of the Jigsaw matcher's training step, written from the algorithm.

Jigsaw (Lu, Sun, Huang, "Jigsaw: Learning to Assemble Multiple Fractured Objects", NeurIPS
2023, arXiv 2305.17975) segments the fracture points of every piece and matches them across
pieces. The reference imports nothing of the program. Parameters come as one dict keyed by
the program's names (``matcher_params.py``); every product goes through a ``Precision``
(``numerics.py``). It sets TF32 off for cuBLAS and cuDNN (``steps``).

* ``MatcherData``: the training batches, in numpy, from the raw pc_data files: the loader's
  shuffle and draw order from its seed, each shape's points split over its pieces in
  proportion to their areas with at least 30 a piece, each piece sampled, recentred,
  rotated at random and shuffled; the fracture-point threshold of every point.
* the encoder, PointNet++ MSG over the flat cloud of all pieces: four set-abstraction
  levels (farthest-point sampling from the first valid point, ties to the lowest index; per
  radius the lowest-index points of the same piece within the radius, slots past the hits
  repeating the first; 1x1 convs each with train-mode BatchNorm and ReLU; the max over the
  neighbourhood), four feature-propagation levels (inverse-distance weights over the 3
  nearest points of the same piece), a last conv with BatchNorm.
* a PointTransformer layer (vector attention over the 16 nearest points of the same piece)
  and masked cross-attention over every valid point (8 heads, post-norm), with its
  feed-forward.
* the fracture-point classifier (BatchNorm over the valid points, ReLU, a linear head).
* matching on each shape's ground-truth critical points, in index order: the affinity
  features (BatchNorm over the critical points of the batch, ReLU, linear, each half
  L2-normalised), the bilinear affinity X_1 A Y_2^T, same-piece pairs set to -1e6, and 20
  log-space Sinkhorn iterations at tau 0.05 over that block (rows, then columns).
* the losses: BCE on the logits (positive weight), the permutation loss (BCE of the
  Sinkhorn matrix against the nearest critical point of another piece, over the block, a
  mean over the rows), the rigid loss (per piece pair i < j: piece i's critical points
  aligned by weighted Horn, without gradient, onto their match-weighted targets on piece j,
  the residual scaled by the pair's match mass, over the count of source points of pairs
  with mass); Adam under the cosine factor.

Squared distances are taken in expanded form, -2 a.b + |a|^2 + |b|^2, with other pieces'
points pushed 1e6 away (1e10 in the kNN), over the same arrays as the program's queries, so
that equal inputs select the same points. The Sinkhorn matrix is built on each shape's valid
block alone, as the algorithm states it.

Departures from the Jigsaw paper and its code, as the program has them:

* point sampling reads each piece's stored cloud (pc_data, sampled with replacement where a
  piece needs more points than it holds), with the area of its bounding box in place of the
  mesh's area;
* the affinity head's BatchNorm takes its statistics over the batch's critical points alone
  (the port's flat layout pads each shape's critical block with its other points);
* the rigid loss stops the gradient through the alignment itself (R, t), as the JAX package
  does; it flows through the match weights, the soft targets and the masses.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from pfpp_bench.reference.numerics import FP32, Precision

FAR = 1e6  # another piece's points in a ball query, a 3-NN or a label's distance
KNN_FAR = 1e10  # another piece's points in the PointTransformer's kNN
BN_EPS, LN_EPS = 1e-5, 1e-6
MASKED = -1e9  # a masked attention score
SAME_PIECE = -1e6  # a same-piece affinity


# ---- the batches ----

def area_split(areas: np.ndarray, num_points: int, least: int) -> np.ndarray:
    """Points a piece: ceil-proportional to the areas, the largest absorbing the rounding;
    then every piece raised to ``least``, taken back from the largest pieces in turn."""
    nps = np.ceil(areas * num_points / areas.sum()).astype(np.int64)
    nps[np.argmax(nps)] -= nps.sum() - num_points
    owed = 0
    for i in range(len(nps)):
        if nps[i] < least:
            owed += least - nps[i]
            nps[i] = least
    while owed > 0:
        k = np.argmax(nps)
        give = min(owed, nps[k] - least)
        nps[k] -= give
        owed -= give
    return nps


class MatcherData:
    """The pc_data files under ``data_dir``, in sorted order."""

    def __init__(self, data_dir: str, d: dict):
        self.items = []
        for f in sorted(f for f in os.listdir(data_dir) if f.endswith(".npz")):
            with np.load(os.path.join(data_dir, f), allow_pickle=True) as z:
                if d["min_num_part"] <= int(z["num_parts"]) <= d["max_num_part"]:
                    self.items.append({"num_parts": int(z["num_parts"]),
                                       "parts": z["part_pcs_gt"][:int(z["num_parts"])]})
        self.d = d

    def item(self, idx: int, rng: np.random.Generator) -> dict:
        s, d = self.items[idx], self.d
        ext = [p.max(0) - p.min(0) for p in s["parts"]]
        areas = np.array([float(2.0 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2])) for e in ext])
        nps = area_split(areas, d["num_points"], d["min_part_point"])
        pts, gts, pid = [], [], []
        for i, src in enumerate(s["parts"]):
            n = int(nps[i])
            gt = src[rng.choice(len(src), n, replace=n > len(src))]
            centred = gt - gt.mean(axis=0)[None]
            rot = Rotation.random(random_state=rng).as_matrix()
            posed = (rot @ centred.T).T
            order = rng.permutation(n)
            pts.append(posed[order])
            gts.append(gt[order])
            pid.append(np.full(n, i, np.int32))
        valids = np.zeros(d["max_num_part"], np.float32)
        valids[:s["num_parts"]] = 1.0
        return {"part_pcs": np.concatenate(pts).astype(np.float32),
                "gt_pcs": np.concatenate(gts).astype(np.float32),
                "piece_id": np.concatenate(pid), "part_valids": valids,
                "thresholds": np.full(d["num_points"], d["fracture_label_threshold"],
                                      np.float32)}

    def batches(self, seed: int, batch: int, count: int) -> list[dict]:
        """The first ``count`` batches of epoch 0: the order shuffled, items drawn in turn
        from one generator, ``default_rng((seed, 0))``."""
        rng = np.random.default_rng((seed, 0))
        order = np.arange(len(self.items))[rng.permutation(len(self.items))]
        if len(order) // batch < count:
            raise ValueError(f"{len(order)} shapes give fewer than {count} batches of {batch}")
        out = []
        for k in range(count):
            items = [self.item(int(i), rng) for i in order[k * batch:(k + 1) * batch]]
            out.append({key: np.stack([it[key] for it in items]) for key in items[0]})
        return out


# ---- selections ----

def sqdist(a, b, prec: Precision):
    """[B, N, 3], [B, M, 3] -> [B, N, M]: -2 a.b + |a|^2 + |b|^2, added in that order."""
    d = -2.0 * prec.ein("bnc,bmc->bnm", a, b)
    d = d + (a ** 2).sum(-1)[..., :, None]
    return d + (b ** 2).sum(-1)[..., None, :]


def piece_sqdist(a, b, a_pid, b_pid, prec: Precision, far: float = FAR):
    return sqdist(a, b, prec) + torch.where(a_pid[:, :, None] == b_pid[:, None, :], 0.0, far)


def gather(x, idx):
    """x [B, N, ...], idx [B, ...] -> the rows of x at idx."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def fps(xyz, npoint: int, valid):
    """Farthest-point sampling over the valid points from the first valid one, ties to the
    lowest index: [B, N, 3] -> [B, npoint]."""
    B = xyz.shape[0]
    dist = torch.where(valid, 1e10, -1e10).to(xyz.dtype)
    far = valid.to(torch.int8).argmax(1)
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz.unbind(-1)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx, dy, dz = x - c[:, :1], y - c[:, 1:2], z - c[:, 2:3]
        dist = torch.minimum(dist, torch.where(valid, dx * dx + dy * dy + dz * dz, -1e10))
        far = dist.argmax(1)
    return out


def ball_query(radius: float, nsample: int, xyz, pid, centres, c_pid, prec: Precision):
    """The ``nsample`` lowest-index points of the centre's piece within ``radius``; slots past
    the hits repeat the first hit, a centre with none takes point 0."""
    N = xyz.shape[1]
    d = piece_sqdist(centres, xyz, c_pid, pid, prec)
    ar = torch.arange(N, device=xyz.device)
    cand = torch.where(d <= radius ** 2, ar, N)
    idx = torch.topk(cand, min(nsample, N), dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == N, idx[..., :1], idx)
    return torch.where(idx == N, 0, idx)


def nearest(d, k: int):
    """The k smallest of the last axis, ascending, ties to the lower index."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


# ---- layers ----

def batch_norm(p, name: str, x, weights=None):
    """Train-mode BatchNorm over the last axis: the batch mean and biased variance over
    every other axis, each point weighted by ``weights`` [B, N] where given."""
    red = tuple(range(x.dim() - 1))
    if weights is None:
        count = x.numel() // x.shape[-1]
        mean = x.sum(red) / count
        var = ((x - mean) ** 2).sum(red) / count
    else:
        w = weights.reshape(weights.shape + (1,) * (x.dim() - weights.dim()))
        count = (w.sum() * math.prod(x.shape[weights.dim():-1])).clamp_min(1e-6)
        mean = (x * w).sum(red) / count
        var = ((x - mean) ** 2 * w).sum(red) / count
    return (x - mean) * torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


def layer_norm(p, name: str, x):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                                          p[f"{name}.bias"], LN_EPS)


def dense(p, name: str, x, prec: Precision):
    return prec.lin(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def conv_bn_relu(p, conv: str, bn: str, x, prec: Precision):
    return torch.relu(batch_norm(p, bn, dense(p, conv, x, prec)))


def sa_level(p, name: str, level: dict, npoint: int, xyz, pid, feats, valid, prec):
    """One set-abstraction level -> (centres, their pieces, features, validity)."""
    idx = fps(xyz, npoint, valid)
    c_xyz, c_pid, c_valid = gather(xyz, idx), torch.gather(pid, 1, idx), torch.gather(valid, 1, idx)
    outs = []
    for r, (radius, nsample, mlp) in enumerate(zip(level["radii"], level["nsamples"],
                                                   level["mlps"])):
        g = ball_query(radius, nsample, xyz, pid, c_xyz, c_pid, prec)
        h = torch.cat([gather(xyz, g) - c_xyz[:, :, None, :], gather(feats, g)], dim=-1)
        for j in range(len(mlp)):
            h = conv_bn_relu(p, f"{name}.conv{r}_{j}", f"{name}.bn{r}_{j}", h, prec)
        outs.append(h.amax(dim=2))
    return c_xyz, c_pid, torch.cat(outs, dim=-1), c_valid


def fp_level(p, name: str, depth: int, fine, coarse, fine_feats, coarse_feats, prec):
    """Inverse-distance interpolation from ``coarse`` (xyz, pid) onto ``fine``'s points over
    the 3 nearest of the same piece, joined with ``fine_feats``, then conv-BN-ReLU layers."""
    d, idx = nearest(piece_sqdist(fine[0], coarse[0], fine[1], coarse[1], prec), 3)
    w = 1.0 / d.clamp_min(1e-10)
    w = w / w.sum(-1, keepdim=True)
    h = (gather(coarse_feats, idx) * w[..., None]).sum(dim=2)
    if fine_feats is not None:
        h = torch.cat([fine_feats, h], dim=-1)
    for j in range(depth):
        h = conv_bn_relu(p, f"{name}.conv{j}", f"{name}.bn{j}", h, prec)
    return h


def encoder(p, m: dict, xyz, pid, valid, prec: Precision):
    """PointNet++ MSG over the flat cloud: [B, N, 3] -> [B, N, pc_feat_dim]."""
    levels, x = [], (xyz, pid, xyz, valid)
    for s, level in enumerate(m["sa_plan"]):
        x = sa_level(p, f"encoder.sa{s + 1}", level, m["sa_npoints"][s], *x, prec)
        levels.append(x)
    fp = dict((k, len(v)) for k, v in m["fp_plan"])
    l1, l2, l3, l4 = levels
    h = fp_level(p, "encoder.fp4", fp["fp4"], l3[:2], l4[:2], l3[2], l4[2], prec)
    h = fp_level(p, "encoder.fp3", fp["fp3"], l2[:2], l3[:2], l2[2], h, prec)
    h = fp_level(p, "encoder.fp2", fp["fp2"], l1[:2], l2[:2], l1[2], h, prec)
    h = fp_level(p, "encoder.fp1", fp["fp1"], (xyz, pid), l1[:2], None, h, prec)
    return batch_norm(p, "encoder.bn1", dense(p, "encoder.conv1", h, prec))


def point_transformer(p, m: dict, xyz, feats, pid, prec: Precision):
    """Vector attention over the ``tf_num_samples`` nearest points of the same piece; the
    attention weights (C / heads of them) shared across each head's channels."""
    t = "tf_self1"
    B, N, _ = xyz.shape
    C, h, k = m["pc_feat_dim"], m["tf_num_heads"], m["tf_num_samples"]
    q, key, v = (dense(p, f"{t}.linear_{n}", feats, prec) for n in "qkv")
    d = torch.where(pid[:, :, None] == pid[:, None, :], sqdist(xyz, xyz, prec), KNN_FAR)
    _, idx = nearest(d, k)
    rel = gather(xyz, idx) - xyz[:, :, None, :]
    pos = dense(p, f"{t}.linear_p1", torch.relu(batch_norm(
        p, f"{t}.linear_p_bn", dense(p, f"{t}.linear_p0", rel, prec))), prec)
    w = gather(key, idx) - q[:, :, None, :] + pos
    w = dense(p, f"{t}.linear_w0", torch.relu(batch_norm(p, f"{t}.linear_w_bn0", w)), prec)
    w = dense(p, f"{t}.linear_w1", torch.relu(batch_norm(p, f"{t}.linear_w_bn1", w)), prec)
    w = torch.softmax(w, dim=2)
    vv = (gather(v, idx) + pos).reshape(B, N, k, h, C // h)
    return prec.ein("bnksi,bnki->bnsi", vv, w).reshape(B, N, C)


def cross_attention(p, m: dict, x, mask, prec: Precision):
    """Masked multi-head attention of x to itself, post-norm, then the feed-forward."""
    a = "tf_cross1.attn"
    B, N, C = x.shape
    h = m["tf_num_heads"]
    q, k, v = (dense(p, f"{a}.{n}", x, prec).reshape(B, N, h, C // h)
               for n in ("w_qs", "w_ks", "w_vs"))
    scores = prec.ein("bqhd,bkhd->bhqk", q, k) / math.sqrt(C // h)
    probs = torch.softmax(torch.where(mask[:, None], scores, MASKED), dim=-1)
    out = prec.ein("bhqk,bkhd->bqhd", probs, v).reshape(B, N, C)
    x = layer_norm(p, f"{a}.layer_norm", dense(p, f"{a}.fc", out, prec) + x)
    f = "tf_cross1.pos_ffn"
    y = dense(p, f"{f}.w_2", torch.relu(dense(p, f"{f}.w_1", x, prec)), prec)
    return layer_norm(p, f"{f}.layer_norm", y + x)


def sinkhorn(s, iters: int, tau: float):
    """Log-space Sinkhorn of one valid [n, n] block: rows, then columns, ``iters`` times."""
    log_s = s / tau
    for _ in range(iters):
        log_s = log_s - torch.logsumexp(log_s, dim=1, keepdim=True)
        log_s = log_s - torch.logsumexp(log_s, dim=0, keepdim=True)
    return torch.exp(log_s)


def fracture_labels(gt, pid, n_parts, thresholds, prec: Precision = FP32):
    """A point is a fracture point where a point of another valid piece lies nearer than
    its threshold: [B, N] bool."""
    valid = pid < n_parts[:, None]
    d = torch.sqrt(sqdist(gt, gt, prec).clamp_min(0.0))
    other = (pid[:, :, None] != pid[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    return (torch.where(other, d, FAR).amin(-1) < thresholds) & valid


def forward(p, cfg: dict, b: dict, prec: Precision = FP32) -> dict:
    """The train-mode forward and the losses of one batch (tensors on one device):
    ``cls_logits`` [B, N], ``ds`` (each shape's [n, n] Sinkhorn block), ``labels``, the
    losses and the critical counts."""
    m, tr = cfg["model"], cfg["train"]
    pts, pid = b["part_pcs"], b["piece_id"].long()
    n_parts = b["part_valids"].sum(-1).long()
    valid = pid < n_parts[:, None]
    labels = fracture_labels(b["gt_pcs"], pid, n_parts, b["thresholds"], prec)
    feats = encoder(p, m, pts, pid, valid, prec)
    feats = point_transformer(p, m, pts, feats, pid, prec)
    feats = cross_attention(p, m, feats, valid[:, None, :] & valid[:, :, None], prec)
    logits = dense(p, "cls_head", torch.relu(batch_norm(p, "cls_bn", feats, valid.float())),
                   prec)[..., 0]

    gt, w = labels.float(), valid.float()
    bce = logits.clamp_min(0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
    wc = w * torch.where(gt > 0, float(tr["cls_pos_weight"]), 1.0)
    cls_loss = (bce * wc).sum() / wc.sum().clamp_min(1.0)

    # each shape's critical points in index order; the affinity's statistics over all
    crit = [torch.nonzero(labels[i])[:, 0] for i in range(pts.shape[0])]
    rows = torch.cat([feats[i, c] for i, c in enumerate(crit)])
    a = dense(p, "aff_head", torch.relu(batch_norm(p, "aff_bn", rows)), prec)
    hd = m["aff_feat_dim"] // 2
    a = torch.cat([a[:, :hd] / a[:, :hd].norm(dim=-1, keepdim=True).clamp_min(1e-12),
                   a[:, hd:] / a[:, hd:].norm(dim=-1, keepdim=True).clamp_min(1e-12)], -1)
    ds, mat_sum, rig, count, start = [], 0.0, 0.0, 0.0, 0
    for i, c in enumerate(crit):
        n = len(c)
        ai, cp = a[start:start + n], pid[i, c]
        start += n
        if n == 0:  # no fracture point: no matching, no loss terms
            ds.append(ai.new_zeros((0, 0)))
            continue
        other = cp[:, None] != cp[None, :]
        s = prec.mm(prec.mm(ai[:, :hd], p["affinity_layer.A"]), ai[:, hd:].T)
        d_i = sinkhorn(torch.where(other, s, SAME_PIECE), m["sinkhorn_iters"],
                       m["sinkhorn_tau"])
        ds.append(d_i)
        # the nearest critical point of another piece, over the program's query arrays
        g = torch.full_like(b["gt_pcs"][i:i + 1], 1e3)
        g[0, :n] = b["gt_pcs"][i, c]
        dist = torch.where(other, sqdist(g, g, prec)[0, :n, :n], FAR)
        target = torch.nn.functional.one_hot(dist.argmin(-1), n).float() * other.float()
        q = d_i.clamp(1e-7, 1.0 - 1e-7)
        mat_sum = mat_sum + (-(target * torch.log(q) + (1.0 - target) * torch.log(1.0 - q))).sum()
        if tr["w_rig"] > 0:
            r_i, c_i = rigid(d_i, pts[i, c], cp, b["part_valids"].shape[-1], prec)
            rig, count = rig + r_i, count + c_i
    n_crit = torch.tensor([len(c) for c in crit], device=pts.device)
    mat_loss = mat_sum / n_crit.sum().clamp_min(1).float()
    rig_loss = rig / max(count, 1.0) if tr["w_rig"] > 0 else torch.zeros((), device=pts.device)
    loss = cls_loss + tr["w_mat"] * mat_loss + tr["w_rig"] * rig_loss
    return {"cls_logits": logits, "ds": ds, "labels": labels, "n_crit": n_crit,
            "cls_loss": cls_loss, "mat_loss": mat_loss, "rig_loss": rig_loss, "loss": loss}


def horn(src, tgt, w):
    """The rigid transform R src + t nearest tgt under weights w (Kabsch, no reflection)."""
    ws = w.sum().clamp_min(1e-12)
    mu_s, mu_t = (src * w[:, None]).sum(0) / ws, (tgt * w[:, None]).sum(0) / ws
    cov = ((src - mu_s) * w[:, None]).T @ (tgt - mu_t)
    u, _, vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(vt.T @ u.T))
    r = vt.T @ torch.diag(torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign])) @ u.T
    return r, mu_t - r @ mu_s


def rigid(ds, pts, cpid, max_parts: int, prec: Precision):
    """One shape's rigid loss terms -> (sum of pair residuals x masses, count of source
    points of pairs with mass)."""
    sym = ds + ds.T
    total, count = 0.0, 0.0
    for i in range(max_parts):
        src = cpid == i
        if not bool(src.any()):
            continue
        for j in range(i + 1, max_parts):
            dst = cpid == j
            a = sym[src][:, dst]
            w, soft = a.sum(1), prec.mm(a, pts[dst])
            mass = a.sum()
            with torch.no_grad():
                r, t = horn(pts[src], soft / w.clamp_min(1e-9)[:, None], w)
            resid = (((pts[src] @ r.T + t) * w[:, None] - soft) ** 2).sum()
            total = total + resid * mass
            count += float(src.sum()) * float(mass > 0)
    return total, count


def cosine_factor(step: int, decay_steps: int) -> float:
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))


def adam(params: dict, grads: dict, state: dict, step: int, lr: float, betas, eps: float):
    """One Adam step in place (bias-corrected moments, no weight decay)."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / (1.0 - b2 ** step) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** step))


def steps(params: dict, cfg: dict, batches: list[dict], decay_steps: int, device,
          prec: Precision = FP32) -> dict:
    """The first ``len(batches)`` steps from ``params`` -> {"loss": [per step], "grad1":
    {name: first gradient}, "params": {name: after}, "ds1": the first step's Sinkhorn
    blocks}. Only the weights that train are read from ``params``'s BatchNorm entries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cfg["train"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()
         if not k.endswith(("running_mean", "running_var"))}
    state, losses, grad1, ds1 = {}, [], None, None
    for k, nb in enumerate(batches):
        b = {key: torch.as_tensor(v, device=device) for key, v in nb.items()}
        out = forward(p, cfg, b, prec)
        out["loss"].backward()
        losses.append(float(out["loss"].detach()))
        grads = {n: (v.grad if v.grad is not None else torch.zeros_like(v)) for n, v in p.items()}
        if k == 0:
            grad1 = {n: g.detach().clone() for n, g in grads.items()}
            ds1 = [d.detach() for d in out["ds"]]
        with torch.no_grad():
            adam(p, grads, state, k + 1, tr["lr"] * cosine_factor(k, decay_steps),
                 tr["betas"], tr["eps"])
        for v in p.values():
            v.grad = None
    return {"loss": losses, "grad1": grad1, "params": {n: v.detach() for n, v in p.items()},
            "ds1": ds1}
