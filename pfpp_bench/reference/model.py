"""Plain PyTorch reference of PuzzleFusion++'s models, written from the algorithm.

It imports nothing of the program. Parameters come as one dict keyed by the original
checkpoints' names (``params.py``); every product goes through a ``Precision``
(``numerics.py``). No kernels, no folding, no caching beyond what the algorithm itself
caches:

* the frozen VQ-VAE encoder: per SA stage farthest-point sampling from the first point,
  ball query keeping the lowest-index points within the radius, the recentred neighbourhood
  (rotated) concatenated with the gathered previous features, three 1x1 convs each followed
  by eval-mode BatchNorm and ReLU, max over the neighbourhood; then conv6 and the nearest
  code of the 1024 x 16 codebook for each quarter of a token. The grouping of a cloud is the
  same under any rotation of it, so the engine's iteration groups the unrotated clouds once
  and rotates the neighbourhoods at each step (``group`` then ``encode``).
* the SE(3) denoiser: NeRF embeddings of poses, scales and token centres, six layers of
  AdaLN, part-local attention, global attention over the valid parts' tokens and a GEGLU
  feed-forward, mean over each part's tokens, two pose heads; dropout where the model has it.
* the verifier: six post-norm encoder layers over the edges' histogram features.
* the DDPM reverse step (epsilon prediction, piecewise alpha-bar, leading spacing).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pfpp_bench.reference.numerics import FP32, Precision

SA_RADII = (0.2, 0.4, 0.8)
NEG_INF = -1e9
BN_EPS = 1e-5


# ---- quaternions (scalar first) ----

def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


def _cross(u, v):
    ux, uy, uz = u.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx], dim=-1)


def quat_apply(q, v):
    """Rotate v [..., 3] by unit q [..., 4]."""
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_apply_raw(q, v):
    """The vector part of q (0, v) q*, q not normalised."""
    p = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    conj = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    return quat_mul(quat_mul(q, p), conj)[..., 1:]


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    m = torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w),
                     s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w),
                     s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


# ---- the frozen encoder ----

def fps(xyz, npoint: int):
    """Farthest-point sampling from point 0, ties to the lowest index: [M, N, 3] -> [M, S]."""
    M, N, _ = xyz.shape
    dist = torch.full((M, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    far = torch.zeros(M, dtype=torch.long, device=xyz.device)
    out = torch.empty((M, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(M, device=xyz.device)
    x, y, z = xyz.unbind(-1)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]
        dx, dy, dz = x - c[:, :1], y - c[:, 1:2], z - c[:, 2:3]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = dist.argmax(1)
    return out


def gather(points, idx):
    """points [M, N, C], idx [M, ...] -> [M, ..., C]."""
    rows = torch.arange(points.shape[0], device=points.device)
    return points[rows.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def ball_query(radius: float, nsample: int, xyz, centres, prec: Precision):
    """The ``nsample`` lowest-index points within ``radius`` of each centre; slots past the
    hits repeat the first hit. [M, N, 3], [M, S, 3] -> [M, S, K]."""
    N = xyz.shape[1]
    d = (-2.0 * prec.ein("msc,mnc->msn", centres, xyz) + (centres ** 2).sum(-1)[..., None]
         + (xyz ** 2).sum(-1)[:, None, :])
    ar = torch.arange(N, device=xyz.device)
    cand = torch.where(d <= radius ** 2, ar, torch.full_like(ar, N))
    idx = torch.topk(cand, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == N, idx[..., :1].expand_as(idx), idx)
    return torch.where(idx == N, torch.zeros_like(idx), idx)


def group(xyz, num_point: int, npoints, nsamples, prec: Precision = FP32):
    """Per SA stage (group_idx [M, S, K], centres [M, S, 3], neighbourhoods [M, S, K, 3])."""
    stages, pts = [], xyz
    for s, n in enumerate((npoints[0], npoints[1], num_point)):
        centres = gather(pts, fps(pts, n))
        idx = ball_query(SA_RADII[s], nsamples[s], pts, centres, prec)
        stages.append((idx, centres, gather(pts, idx) - centres[:, :, None, :]))
        pts = centres
    return stages


def _bn_relu(p, name: str, h):
    """Eval-mode BatchNorm over the last axis, then ReLU."""
    h = (h - p[f"{name}.running_mean"]) * torch.rsqrt(p[f"{name}.running_var"] + BN_EPS)
    return torch.relu(h * p[f"{name}.weight"] + p[f"{name}.bias"])


def _conv_bn_relu(p, name: str, h, prec: Precision):
    conv = name.replace("bns", "convs")
    return _bn_relu(p, name, prec.lin(h, p[f"{conv}.weight"].flatten(1), p[f"{conv}.bias"]))


def encode(p, stages, rot, num_dim: int, e_dim: int, prec: Precision = FP32):
    """Clouds grouped by ``group``, each rotated by rot [M, 3, 3] (None: as grouped)
    -> (z_q [M, L, num_dim], token centres [M, L, 3])."""
    feats = None
    for s, (idx, centres, nbhd) in enumerate(stages):
        name = f"pn2.sa{s + 1}.mlp_convs.0"
        if rot is None:  # the clouds were grouped as posed: conv0 of the concatenation
            h = nbhd if feats is None else torch.cat([nbhd, gather(feats, idx)], dim=-1)
            h = prec.lin(h, p[f"{name}.weight"].flatten(1), p[f"{name}.bias"])
        else:  # rotated neighbourhoods, and the features projected once and then gathered
            w0 = p[f"{name}.weight"].flatten(1)
            h = prec.lin(prec.ein("mskd,med->mske", nbhd, rot), w0[:, :3], p[f"{name}.bias"])
            if feats is not None:
                h = h + gather(prec.lin(feats, w0[:, 3:]), idx)
        h = _bn_relu(p, f"pn2.sa{s + 1}.mlp_bns.0", h)
        for j in (1, 2):
            h = _conv_bn_relu(p, f"pn2.sa{s + 1}.mlp_bns.{j}", h, prec)
        feats = h.amax(dim=2)
    z = prec.lin(feats, p["pn2.conv6.weight"].flatten(1), p["pn2.conv6.bias"])
    M, L, _ = z.shape
    cb = p["vector_quantization.embedding.weight"]
    flat = z.reshape(M, -1, e_dim)
    d = ((flat ** 2).sum(-1, keepdim=True) + (cb ** 2).sum(-1)
         - 2.0 * prec.ein("mtc,ec->mte", flat, cb))
    z_q = cb[d.argmin(-1)].reshape(M, L, num_dim)
    xyz = stages[-1][1]
    if rot is not None:
        xyz = prec.ein("msd,med->mse", xyz, rot)
    return z_q, xyz


def valid_first(valids):
    """Slots of the valid parts first, then the valid parts again in turn: (order, src,
    slot_valid) [B, P]; the encoder sees every slot, the denoiser only the valid parts."""
    P = valids.shape[-1]
    v = valids.long()
    order = torch.argsort(1 - v, dim=-1, stable=True)
    n = v.sum(-1, keepdim=True)
    slots = torch.arange(P, device=valids.device)[None]
    src = torch.gather(order, 1, slots % n.clamp_min(1))
    return order, src, (slots < n) & (n > 0)


def features(p, cfg: dict, part_pcs, valids, quat, stages=None, prec: Precision = FP32):
    """Latents and token centres of every part posed by the unit ``quat`` [B, P, 4]
    -> ([B, P, L, num_dim], [B, P, L, 3]), zero for invalid parts. With ``stages`` (the
    grouping of the unrotated, valid-first clouds) the neighbourhoods are rotated; without,
    the rotated clouds are grouped."""
    B, P, N, _ = part_pcs.shape
    order, src, slot_valid = valid_first(valids)
    q = torch.gather(quat, 1, src[..., None].expand(B, P, 4)).reshape(B * P, 4)
    if stages is None:
        clouds = torch.gather(part_pcs, 1, src[..., None, None].expand(B, P, N, 3))
        rotated = quat_apply(q[:, None, :], clouds.reshape(B * P, N, 3))
        stages = group(rotated, cfg["num_point"], cfg["sa_npoints"], cfg["sa_nsamples"], prec)
        rot = None
    else:
        rot = quat_to_matrix(q)
    z_q, xyz = encode(p, stages, rot, cfg["num_dim"], cfg["embedding_dim"], prec)
    L = z_q.shape[1]

    def back(x):
        x = x.reshape(B, P, L, -1)
        x = torch.where(slot_valid[..., None, None], x, torch.zeros_like(x))
        out = torch.zeros_like(x)
        return out.scatter(1, order[..., None, None].expand_as(x), x)

    return back(z_q), back(xyz)


def iteration_grouping(cfg: dict, part_pcs, valids, prec: Precision = FP32):
    """The grouping of one engine iteration: the unrotated clouds, valid parts first."""
    B, P, N, _ = part_pcs.shape
    _, src, _ = valid_first(valids)
    clouds = torch.gather(part_pcs, 1, src[..., None, None].expand(B, P, N, 3))
    return group(clouds.reshape(B * P, N, 3), cfg["num_point"], cfg["sa_npoints"],
                 cfg["sa_nsamples"], prec)


# ---- the denoiser ----

def nerf(x, num_freqs: int):
    out = [x]
    for f in 2.0 ** np.linspace(0.0, num_freqs - 1.0, num_freqs):
        out += [torch.sin(x * float(f)), torch.cos(x * float(f))]
    return torch.cat(out, dim=-1)


def sinusoids(max_len: int, d: int, device) -> torch.Tensor:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float64)
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * div), np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def attention(q, k, v, heads: int, bias, prec: Precision):
    B, T, C = q.shape
    hd = C // heads
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
    out = prec.mm(torch.softmax(s, dim=-1), v)
    return out.transpose(1, 2).reshape(B, T, C)


def _drop(x, rate: float, train: bool):
    return F.dropout(x, rate, training=True) if train and rate else x


def denoiser(p, cfg: dict, x, t, latent, xyz, valids, scale, ref, train: bool = False,
             prec: Precision = FP32):
    """x [B, P, 7], t [B], latent [B, P, L, num_dim], xyz [B, P, L, 3], valids [B, P],
    scale [B, P, 1], ref [B, P] -> predicted noise [B, P, 7]."""
    B, P, L, _ = latent.shape
    C, nf, heads = cfg["embed_dim"], cfg["multires"], cfg["num_heads"]
    rate = cfg["dropout"]
    shape_in = torch.cat([latent, nerf(xyz, nf),
                          nerf(scale, nf)[:, :, None, :].expand(B, P, L, -1)], dim=-1)
    h = prec.lin(shape_in, p["shape_embedding.weight"], p["shape_embedding.bias"])
    pose = prec.lin(nerf(x, nf), p["param_fc.weight"], p["param_fc.bias"])
    pose = pose + p["ref_part_emb.weight"][ref.long()]
    data = pose[:, :, None, :] + h + sinusoids(P, C, x.device)[None, :, None, :]
    data = _drop(data, cfg["pe_dropout"], train).reshape(B, P * L, C)

    part = torch.arange(P * L, device=x.device) // L
    zero = torch.zeros((), device=x.device)
    neg = torch.full((), NEG_INF, device=x.device)
    local_bias = torch.where(part[:, None] == part[None, :], zero, neg)[None, None]
    tok_valid = valids.bool().repeat_interleave(L, dim=1)
    global_bias = torch.where(tok_valid, zero, neg)[:, None, None, :]

    def ada(x, name):
        emb = p[f"{name}.emb.weight"][t]
        scale_shift = prec.lin(F.silu(emb), p[f"{name}.linear.weight"], p[f"{name}.linear.bias"])
        sc, sh = scale_shift.chunk(2, dim=-1)
        return F.layer_norm(x, x.shape[-1:], eps=1e-5) * (1.0 + sc[:, None]) + sh[:, None]

    def attn(x, name, bias):
        q, k, v = (prec.lin(x, p[f"{name}.{n}.weight"]) for n in ("to_q", "to_k", "to_v"))
        out = prec.lin(attention(q, k, v, heads, bias, prec), p[f"{name}.to_out.0.weight"],
                       p[f"{name}.to_out.0.bias"])
        return _drop(out, rate, train)

    for i in range(cfg["num_layers"]):
        n = f"transformer_layers.{i}"
        data = data + attn(ada(data, f"{n}.norm1"), f"{n}.self_attn", local_bias)
        data = data + attn(ada(data, f"{n}.norm2"), f"{n}.global_attn", global_bias)
        y = F.layer_norm(data, data.shape[-1:], p[f"{n}.norm3.weight"], p[f"{n}.norm3.bias"],
                         eps=1e-5)
        hid, gate = prec.lin(y, p[f"{n}.ff.net.0.proj.weight"],
                             p[f"{n}.ff.net.0.proj.bias"]).chunk(2, dim=-1)
        y = _drop(hid * F.gelu(gate), rate, train)
        data = data + prec.lin(y, p[f"{n}.ff.net.2.weight"], p[f"{n}.ff.net.2.bias"])

    out = data.reshape(B, P, L, C).mean(dim=2)

    def head(name):
        y = F.silu(prec.lin(out, p[f"{name}.0.weight"], p[f"{name}.0.bias"]))
        y = F.silu(prec.lin(y, p[f"{name}.2.weight"], p[f"{name}.2.bias"]))
        return prec.lin(y, p[f"{name}.4.weight"], p[f"{name}.4.bias"])

    return torch.cat([head("mlp_out_trans"), head("mlp_out_rot")], dim=-1)


# ---- the verifier ----

def verifier(p, cfg: dict, feats, edges, edge_valids, prec: Precision = FP32):
    """feats [B, E, 7], edges [B, E, 2], edge_valids [B, E] -> logits [B, E]."""
    B, E, _ = edges.shape
    D = cfg["embed_dim"]
    x = sinusoids(cfg["max_nodes"], D // 2, feats.device)[edges.long()].reshape(B, E, D)
    x = x + prec.lin(feats, p["edge_feature_emb.weight"], p["edge_feature_emb.bias"])
    zero = torch.zeros((), device=feats.device)
    bias = torch.where(edge_valids.bool(), zero,
                       torch.full((), NEG_INF, device=feats.device))[:, None, None, :]
    for i in range(cfg["num_layers"]):
        n = f"transformer_encoder.layers.{i}"
        q, k, v = prec.lin(x, p[f"{n}.self_attn.in_proj_weight"],
                           p[f"{n}.self_attn.in_proj_bias"]).chunk(3, dim=-1)
        a = prec.lin(attention(q, k, v, cfg["num_heads"], bias, prec),
                     p[f"{n}.self_attn.out_proj.weight"], p[f"{n}.self_attn.out_proj.bias"])
        x = F.layer_norm(x + a, (D,), p[f"{n}.norm1.weight"], p[f"{n}.norm1.bias"], eps=1e-5)
        ff = prec.lin(F.gelu(prec.lin(x, p[f"{n}.linear1.weight"], p[f"{n}.linear1.bias"])),
                      p[f"{n}.linear2.weight"], p[f"{n}.linear2.bias"])
        x = F.layer_norm(x + ff, (D,), p[f"{n}.norm2.weight"], p[f"{n}.norm2.bias"], eps=1e-5)
    return prec.lin(x, p["mlp_out.weight"], p["mlp_out.bias"])[..., 0]


# ---- the DDPM schedule ----

class DDPM:
    """The piecewise alpha-bar schedule: 1 -> 0.9 quadratically up to t = 0.7, then -> 0."""

    def __init__(self, steps: int = 1000):
        def abar(t):
            t = np.asarray(t, np.float64) * 1000.0
            return np.where(t <= 700.0, 1.0 - 0.1 * (t / 700.0) ** 2,
                            0.9 * (1.0 - ((t - 700.0) / 300.0) ** 2))

        i = np.arange(steps, dtype=np.float64)
        self.betas = np.minimum(1.0 - abar((i + 1) / steps) / abar(i / steps),
                                0.999).astype(np.float32)
        alphas = (1.0 - self.betas).astype(np.float32)
        self.abar = np.cumprod(alphas.astype(np.float64)).astype(np.float32)
        self.steps = steps

    def timesteps(self, n: int) -> list[int]:
        """Leading spacing: [950, 900, ..., 0] for 1000 -> 20."""
        ratio = self.steps // n
        return [int(t) for t in (np.arange(n) * ratio).round()[::-1]]

    def add_noise(self, x0, noise, t):
        a = torch.as_tensor(self.abar, device=x0.device)[t.long()][:, None, None]
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def step(self, eps, t: int, x, z, n: int):
        """One reverse step (fixed-small variance, no clipping), float32 coefficients."""
        f = np.float32
        prev = t - self.steps // n
        a_t = f(self.abar[t])
        a_p = f(self.abar[prev]) if prev >= 0 else f(1.0)
        b_t, b_p = f(1.0) - a_t, f(1.0) - a_p
        alpha = a_t / a_p
        beta = f(1.0) - alpha
        x0 = (x - float(np.sqrt(b_t)) * eps) / float(np.sqrt(a_t))
        out = float(np.sqrt(a_p) * beta / b_t) * x0 + float(np.sqrt(alpha) * b_p / b_t) * x
        if t > 0:
            out = out + float(np.sqrt(f(max(b_p / b_t * beta, f(1e-20))))) * z
        return out
