"""Plain reference of the denoiser's training steps, for the training cells' check.

``steps`` reads the raw training files the program's loader reads, and works out again what
the loader makes of them for the first steps of epoch 0: the shuffled order and the batches
(``default_rng((seed, 0))``), and per shape, in the loader's draw order, the whole-shape
rotation and recentring on the reference part, the per-part recentring and rotation that
give the GT pose (``recentre_rotate``), the max-abs normalisation, and the curriculum that
makes connected parts references with noised poses (PuzzleFusion++ ``denoiser/dataset/dataset.py``). Then each
step: timesteps and noise drawn from the step generator as the program's trainer draws
them, the forward-process noising with the reference parts pinned, the frozen encoder on
the posed clouds, the denoiser with dropout (its masks drawn after the same seeding as the
program's rank that computes those rows), the MSE over the valid non-reference parts, the
gradient summed over the ranks' rows, and AdamW.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from pfpp_bench.reference import model as R
from pfpp_bench.reference.numerics import FP32, Precision


def _pad(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + tuple(x.shape[1:]), np.float32)
    out[:min(n, len(x))] = x[:n]
    return out


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def recentre_rotate(pcs: np.ndarray, mats: np.ndarray):
    """Each part recentred on its centroid and rotated, in the arithmetic of the loader's
    native host core (``csrc/pfpp_native.cpp``, ``g++ -O3 -march=native``): the centroid a
    sequential float32 sum over the points divided by their count, each rotated coordinate
    ``fma(r2, z, fma(r0, x, r1 * y))``. The same inputs then give the same bits, so the
    posed encode's farthest-point and ball-query choices see what the program's do.
    pcs [P, N, 3] f32, mats [P, 3, 3] f32 -> (rotated [P, N, 3], centroids [P, 3])."""
    n = np.float32(pcs.shape[1])
    cen = (np.add.accumulate(pcs, axis=1, dtype=np.float32)[:, -1] / n).astype(np.float32)
    d = (pcs - cen[:, None, :]).astype(np.float32)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    m = mats.astype(np.float32)
    out = np.stack([_fma(m[:, i, 2, None], z, _fma(m[:, i, 0, None], x, m[:, i, 1, None] * y))
                    for i in range(3)], axis=-1)
    return out, cen


class TrainData:
    """The training files under ``data_dir``, in the loader's sorted order."""

    def __init__(self, data_dir: str, max_parts: int, curriculum: bool):
        files = sorted(f for f in os.listdir(data_dir) if f.endswith(".npz"))
        self.items = []
        for f in files:
            with np.load(os.path.join(data_dir, f), allow_pickle=True) as d:
                self.items.append({k: d[k] for k in d.files})
        self.P, self.curriculum = max_parts, curriculum
        abar = np.cumprod(1.0 - R.DDPM().betas.astype(np.float64))
        self.sq_a = np.sqrt(abar).astype(np.float32)
        self.sq_1ma = np.sqrt(1.0 - abar).astype(np.float32)

    def item(self, idx: int, rng: np.random.Generator) -> dict:
        s = self.items[idx]
        n = int(s["num_parts"])
        gt = s["part_pcs_gt"][:n]
        ref = s["ref_part"].copy()
        rot = Rotation.random(random_state=rng).as_matrix()
        flat = (rot @ gt.reshape(-1, 3).T).T
        pcs = flat.reshape(n, -1, 3)
        pcs = pcs - pcs[int(np.where(ref[:n])[0].item())].mean(axis=0)
        mats = np.empty((n, 3, 3), np.float32)
        quats = np.empty((n, 4), np.float32)
        for p in range(n):
            m = Rotation.random(random_state=rng).as_matrix()
            mats[p] = m
            quats[p] = Rotation.from_matrix(m.T).as_quat()[[3, 0, 1, 2]]
        pts, centroids = recentre_rotate(pcs.astype(np.float32), mats)
        P = self.P
        cur = _pad(pts, P)
        scale = np.max(np.abs(cur), axis=(1, 2), keepdims=True)
        scale[scale == 0] = 1
        d = {"part_pcs": (cur / scale).astype(np.float32), "part_rots": _pad(quats, P),
             "part_trans": _pad(centroids, P), "part_scale": scale[..., 0].astype(np.float32),
             "part_valids": _pad(s["part_valids"][:, None], P)[:, 0],
             "ref_part": _pad(ref.astype(np.float32)[:, None], P)[:, 0].astype(bool),
             "num_parts": n}
        graph = np.zeros((P, P), bool)
        g = s["graph"].astype(bool)
        graph[:g.shape[0], :g.shape[1]] = g[:P, :P]
        if self.curriculum and not (n == 2 or rng.random() < 0.5):
            ref_idx = np.where(d["ref_part"])[0]
            connect = np.where(graph[ref_idx, :])[1]
            larger = [p for p in connect if d["part_scale"][p] > 0.05]
            if larger:
                k = rng.integers(0, len(larger))
                sampled = rng.choice(connect, k, replace=False)
                d["ref_part"][sampled] = True
                t = int(rng.integers(0, 50))
                for key in ("part_trans", "part_rots"):
                    x = d[key][sampled]
                    noise = rng.standard_normal(x.shape).astype(np.float32)
                    d[key][sampled] = self.sq_a[t] * x + self.sq_1ma[t] * noise
        return d

    def batches(self, seed: int, batch: int, count: int) -> list[dict]:
        """The first ``count`` global batches of epoch 0, shuffled, the last partial one
        dropped, items drawn in order from one generator."""
        rng = np.random.default_rng((seed, 0))
        order = np.arange(len(self.items))[rng.permutation(len(self.items))]
        out = []
        for start in range(0, len(order) - batch + 1, batch):
            if len(out) == count:
                break
            items = [self.item(int(i), rng) for i in order[start:start + batch]]
            out.append({k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]})
        if len(out) < count:
            raise ValueError(f"{len(self.items)} shapes give fewer than {count} batches of {batch}")
        # the remaining batches of the epoch draw after these; the check never reads them
        return out


def adamw(params: dict, grads: dict, state: dict, step: int, lr: float, betas, wd: float,
          eps: float = 1e-8) -> None:
    """One decoupled-weight-decay Adam step in place (PyTorch's ``AdamW`` arithmetic)."""
    b1, b2 = betas
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        p.mul_(1.0 - lr * wd)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / (1.0 - b2 ** step) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** step))


def steps(params: dict, cfg: dict, batches: list[dict], noise_seed: int, dropout_seeds,
          world: int, device, prec: Precision = FP32, half: bool = False) -> dict:
    """The first ``len(batches)`` steps from ``params`` (``vqvae``, ``denoiser``) ->
    {"loss": [per step], "grad1": {name: first gradient}, "params": {name: after}}.
    ``dropout_seeds[k][r]`` seeds the global generator before rank r's rows of step k.
    ``half`` plants a fault for the readings: each rank's second half of rows is left out
    and the mean taken over the rest."""
    vq = params["vqvae"]
    den = {k: v.detach().clone().requires_grad_(True) for k, v in params["denoiser"].items()}
    dc, vc, tc = cfg["denoiser"], cfg["vqvae"], cfg["train"]
    ddpm = R.DDPM(dc["ddpm_train_steps"])
    g = torch.Generator(device=device).manual_seed(noise_seed)
    state, losses, grad1 = {}, [], None
    for k, nb in enumerate(batches):
        b = {key: torch.as_tensor(v, device=device) for key, v in nb.items()}
        B, P = b["part_valids"].shape
        t = torch.randint(0, ddpm.steps, (B,), generator=g, device=device)
        noise = torch.randn((B, P, 7), generator=g, device=device)
        gt = torch.cat([b["part_trans"], b["part_rots"]], -1)
        ref = b["ref_part"].bool()
        noisy = torch.where(ref[..., None], gt, ddpm.add_noise(gt, noise, t))
        w = ((b["part_valids"] > 0) & ~ref)[..., None].float()
        if half:
            w = w * (torch.arange(B, device=device) % (B // world) < B // world // 2
                     ).float()[:, None, None]
        count = (w.sum() * 7.0).clamp_min(1.0)
        loss = 0.0
        per = B // world
        for r in range(world):  # a rank's rows at a time, as the program's ranks hold them
            rows = slice(r * per, (r + 1) * per)
            with torch.no_grad():
                latent, xyz = R.features(vq, vc, b["part_pcs"][rows], b["part_valids"][rows],
                                         R.quat_normalize(noisy[rows, :, 3:]), None, prec)
            torch.manual_seed(dropout_seeds[k][r])
            pred = R.denoiser(den, dc, noisy[rows], t[rows], latent, xyz,
                              b["part_valids"][rows], b["part_scale"][rows], ref[rows],
                              train=True, prec=prec)
            part = ((pred - noise[rows]) ** 2 * w[rows]).sum() / count
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in den.items()}
        if k == 0:
            grad1 = {n: v.detach().clone() for n, v in grads.items()}
        with torch.no_grad():
            adamw({n: p for n, p in den.items()}, grads, state, k + 1, tc["lr"], tc["betas"],
                  tc["weight_decay"])
        for p in den.values():
            p.grad = None
    return {"loss": losses, "grad1": grad1,
            "params": {n: p.detach() for n, p in den.items()}}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |‖prog‖ - ‖ref‖| over the larger of ‖ref‖ and the median leaf's."""
    names = [n for n in ref if keep is None or keep(n)]
    norms = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for n in names:
        gap = abs(float(torch.linalg.vector_norm(prog[n].float().to(ref[n].device))) - norms[n])
        worst = max(worst, gap / max(norms[n], median, 1e-30))
    return worst
