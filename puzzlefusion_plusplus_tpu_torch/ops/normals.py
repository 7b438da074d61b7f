"""Point-cloud normal estimation (port of ``puzzlefusion_plusplus_tpu/ops/normals.py``).

kNN neighbourhood -> 3x3 covariance -> eigenvector of the smallest eigenvalue by the
closed-form Cardano solution, then pytorch3d's sign disambiguation (flip when fewer than
half of the neighbour offsets project positively). ``analytic`` gathers the [B, N, K, 3]
neighbourhoods (kernel G on CUDA tensors); ``lowmem`` works coordinate by coordinate in a
[B, K, N] layout with less temporary memory. The engine picks ``lowmem`` at batch >= 16.
"""

from __future__ import annotations

import math

import torch

from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points, knn_points


def smallest_eigvec_sym3x3_coeffs(a00, a01, a02, a11, a12, a22):
    """Unit eigenvector (vx, vy, vz) of the smallest eigenvalue of symmetric 3x3 matrices
    given as six equal-shape coefficient tensors; e_x for a degenerate eigenspace."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00**2 + b11**2 + b22**2 + 2.0 * (a01**2 + a02**2 + a12**2)) / 6.0
    p = torch.sqrt(p2.clamp_min(0.0))
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    safe_p = p.clamp_min(1e-30)
    r = (det_b / (2.0 * safe_p**3)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0 = (a00 - lam, a01, a02)
    r1 = (a01, a11 - lam, a12)
    r2 = (a02, a12, a22 - lam)

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                u[0] * v[1] - u[1] * v[0])

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01 = c01[0] ** 2 + c01[1] ** 2 + c01[2] ** 2
    n02 = c02[0] ** 2 + c02[1] ** 2 + c02[2] ** 2
    n12 = c12[0] ** 2 + c12[1] ** 2 + c12[2] ** 2
    use02 = n02 > n01
    best_n = torch.where(use02, n02, n01)
    v = [torch.where(use02, c02[i], c01[i]) for i in range(3)]
    use12 = n12 > best_n
    best_n = torch.where(use12, n12, best_n)
    v = [torch.where(use12, c12[i], v[i]) for i in range(3)]
    norm = torch.sqrt(best_n)
    ok = norm > 1e-20
    inv = 1.0 / norm.clamp_min(1e-30)
    one, zero = torch.ones_like(norm), torch.zeros_like(norm)
    return (torch.where(ok, v[0] * inv, one), torch.where(ok, v[1] * inv, zero),
            torch.where(ok, v[2] * inv, zero))


def estimate_pointcloud_normals(pcs: torch.Tensor, neighborhood_size: int = 20,
                                valid: torch.Tensor | None = None,
                                method: str = "analytic") -> torch.Tensor:
    """pcs [B, N, 3] -> unit normals [B, N, 3]. ``method``: analytic | lowmem."""
    B, N, _ = pcs.shape
    K = neighborhood_size
    _, idx = knn_points(pcs, pcs, K, valid=valid)  # [B, N, K], includes self
    if method == "analytic":
        nbrs = index_points(pcs, idx)  # [B, N, K, 3]
        centered = nbrs - nbrs.mean(dim=2, keepdim=True)
        cov = torch.einsum("bnki,bnkj->bnij", centered, centered)
        vx, vy, vz = smallest_eigvec_sym3x3_coeffs(
            cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
            cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2],
        )
        normals = torch.stack([vx, vy, vz], dim=-1)
        proj = torch.einsum("bnki,bni->bnk", nbrs - pcs[:, :, None, :], normals)
        flip = (proj > 0).sum(-1) < 0.5 * K
        return torch.where(flip[..., None], -normals, normals)
    if method != "lowmem":
        raise ValueError(f"unknown normals method {method!r}")
    idx_t = idx.transpose(1, 2)  # [B, K, N]
    nbr = [torch.gather(pcs[..., c][:, None, :].expand(B, K, N), 2, idx_t) for c in range(3)]
    mean = [m.mean(dim=1) for m in nbr]
    cen = [nbr[c] - mean[c][:, None, :] for c in range(3)]
    cov = {(c, d): (cen[c] * cen[d]).sum(dim=1) for c in range(3) for d in range(c, 3)}
    vx, vy, vz = smallest_eigvec_sym3x3_coeffs(
        cov[(0, 0)], cov[(0, 1)], cov[(0, 2)], cov[(1, 1)], cov[(1, 2)], cov[(2, 2)]
    )
    v = (vx, vy, vz)
    proj = sum((nbr[c] - pcs[..., c][:, None, :]) * v[c][:, None, :] for c in range(3))
    sign = torch.where((proj > 0).sum(dim=1) < 0.5 * K, -1.0, 1.0)
    return torch.stack([vx * sign, vy * sign, vz * sign], dim=-1)
