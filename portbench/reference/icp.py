"""Point-to-point ICP in float64, in plain PyTorch, written from KISS-ICP's
registration (Vizzo et al., "KISS-ICP", RA-L 2023, and its
Registration.cpp): the nearest map point within the 27 voxels around a
point's voxel, correspondences closer than `max_corr`, Geman-McClure
weights k^2 / (k + |r|^2)^2, the Gauss-Newton step of J = [I | -hat(s)]
with a 1e-6 Tikhonov floor, the increment exp(dx) (translation first)
applied on the left. It stops after `iterations` steps, or where fewer
than 6 correspondences remain.
"""

from __future__ import annotations

import torch

OFF = 1 << 20          # voxel coordinates shifted to be non-negative
BITS = 21


def _keys(v: torch.Tensor) -> torch.Tensor:
    v = v + OFF
    return (v[..., 0] << (2 * BITS)) | (v[..., 1] << BITS) | v[..., 2]


class VoxelNN:
    """Nearest neighbour among the points of the 27 voxels around a query's
    voxel (edge `voxel`)."""

    def __init__(self, pts: torch.Tensor, voxel: float):
        self.pts, self.voxel = pts, voxel
        keys = _keys(torch.floor(pts / voxel).to(torch.int64))
        order = torch.argsort(keys)
        skeys = keys[order]
        self.ukeys, counts = torch.unique_consecutive(skeys,
                                                      return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        width = int(counts.max()) if counts.numel() else 1
        slot = torch.arange(width, device=pts.device)
        idx = starts[:, None] + slot[None]
        self.table = torch.where(slot[None] < counts[:, None],
                                 order[idx.clamp(max=len(order) - 1)],
                                 torch.full_like(idx, -1))
        d = torch.arange(-1, 2, device=pts.device)
        self.offsets = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                                   -1).reshape(27, 3)

    def query(self, q: torch.Tensor, block: int = 4096):
        """(squared distance, index) of each query's nearest point; inf and
        0 where its 27 voxels hold none."""
        d2s, idxs = [], []
        for b in range(0, len(q), block):
            qb = q[b:b + block]
            vox = torch.floor(qb / self.voxel).to(torch.int64)
            keys = _keys(vox[:, None, :] + self.offsets[None])      # (n, 27)
            at = torch.searchsorted(self.ukeys, keys).clamp(
                max=len(self.ukeys) - 1)
            found = self.ukeys[at] == keys
            cand = torch.where(found[..., None], self.table[at], -1)
            cand = cand.reshape(len(qb), -1)                         # (n, c)
            diff = qb[:, None, :] - self.pts[cand.clamp(min=0)]
            d2 = (diff * diff).sum(-1)
            d2 = torch.where(cand >= 0, d2, torch.inf)
            best, k = d2.min(dim=1)
            d2s.append(best)
            idxs.append(torch.gather(cand, 1, k[:, None])[:, 0].clamp(min=0))
        return torch.cat(d2s), torch.cat(idxs)


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(dx: torch.Tensor) -> torch.Tensor:
    """(rho, theta) -> 4 x 4."""
    rho, theta = dx[:3], dx[3:]
    a = torch.linalg.vector_norm(theta)
    K = _hat(theta)
    eye = torch.eye(3, dtype=dx.dtype, device=dx.device)
    if a < 1e-10:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A, B, C = torch.sin(a) / a, (1 - torch.cos(a)) / a ** 2, \
            (a - torch.sin(a)) / a ** 3
    T = torch.eye(4, dtype=dx.dtype, device=dx.device)
    T[:3, :3] = eye + A * K + B * (K @ K)
    T[:3, 3] = (eye + B * K + C * (K @ K)) @ rho
    return T


def register(src: torch.Tensor, map_pts: torch.Tensor, init: torch.Tensor,
             max_corr: float, kernel: float, voxel: float,
             iterations: int) -> torch.Tensor:
    """The pose (4 x 4, float64) that registers src (N, 3) to map_pts
    (M, 3) from `init`, after `iterations` Gauss-Newton steps."""
    f64 = torch.float64
    src, map_pts, init = src.to(f64), map_pts.to(f64), init.to(f64)
    nn = VoxelNN(map_pts, voxel)
    cur = src @ init[:3, :3].T + init[:3, 3]
    T = torch.eye(4, dtype=f64, device=src.device)
    eye6 = 1e-6 * torch.eye(6, dtype=f64, device=src.device)
    for _ in range(iterations):
        d2, idx = nn.query(cur)
        corr = d2 < max_corr * max_corr
        if int(corr.sum()) < 6:
            break
        s, r = cur[corr], cur[corr] - map_pts[idx[corr]]
        w = kernel * kernel / (kernel + (r * r).sum(-1)) ** 2
        J = torch.cat([torch.eye(3, dtype=f64, device=src.device)
                       .expand(len(s), 3, 3), -_hat(s)], dim=2)  # (n, 3, 6)
        JTJ = (w[:, None, None] * J.transpose(1, 2) @ J).sum(0)
        JTr = (w[:, None] * (J.transpose(1, 2) @ r[..., None])[..., 0]) \
            .sum(0)
        dx = torch.linalg.solve(JTJ + eye6, -JTr)
        dT = se3_exp(dx)
        cur = cur @ dT[:3, :3].T + dT[:3, 3]
        T = dT @ T
    return T @ init
