"""Real spherical harmonics + Wigner rotation LUT (host-side, numpy).

eSCN (Passaro & Zitnick, 2023; EquiformerV2 arXiv:2306.12059) rotates each
edge's features into a frame where the edge direction is the z-axis; the
SO(3) convolution then reduces to a block-diagonal SO(2) mixing over
|m| <= m_max — the O(L^6) -> O(L^3) trick.

Per-edge Wigner matrices are *quantized*, as in the reference
(``repro.models.gnn.wigner``, of which this is a line-for-line copy): edge
directions are bucketed into an (n_theta x n_phi) grid and the rotation block
matrix for each bucket is precomputed here once (least-squares fit of the
real-SH basis change, numerically robust, no e3nn dependency).  The model
gathers LUT[bin(edge)] on the device.  Same NumPy code and seed, so the LUT
equals the reference's bit for bit (default 32x64 = 2048 bins).
"""
from __future__ import annotations

import numpy as np


def real_sph_harm(l_max: int, dirs: np.ndarray) -> np.ndarray:
    """Orthonormal real spherical harmonics.  dirs (M, 3) unit -> (M, K)."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ct = np.clip(z, -1.0, 1.0)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    phi = np.arctan2(y, x)
    m_count = dirs.shape[0]
    K = (l_max + 1) ** 2
    # associated Legendre P_l^m (no Condon–Shortley phase)
    P = np.zeros((l_max + 1, l_max + 1, m_count))
    P[0, 0] = 1.0
    for m in range(1, l_max + 1):
        P[m, m] = (2 * m - 1) * st * P[m - 1, m - 1]
    for m in range(l_max):
        P[m + 1, m] = (2 * m + 1) * ct * P[m, m]
    for m in range(l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[l, m] = ((2 * l - 1) * ct * P[l - 1, m] - (l + m - 1) * P[l - 2, m]) / (
                l - m
            )
    out = np.zeros((m_count, K))
    from math import factorial, pi, sqrt

    for l in range(l_max + 1):
        for m in range(l + 1):
            N = sqrt((2 * l + 1) / (4 * pi) * factorial(l - m) / factorial(l + m))
            if m == 0:
                out[:, l * l + l] = N * P[l, 0]
            else:
                out[:, l * l + l + m] = sqrt(2) * N * P[l, m] * np.cos(m * phi)
                out[:, l * l + l - m] = sqrt(2) * N * P[l, m] * np.sin(m * phi)
    return out


def _rot_to_z(theta: float, phi: float) -> np.ndarray:
    """Rotation matrix sending direction (theta, phi) to the +z axis."""
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    rz = np.array([[cp, sp, 0], [-sp, cp, 0], [0, 0, 1.0]])
    ry = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
    return ry @ rz


def wigner_block(l_max: int, R: np.ndarray, samples: np.ndarray,
                 Y_pinv_blocks: list) -> np.ndarray:
    """(K, K) block-diag real-SH rotation matrix for rotation R (via LSQ)."""
    K = (l_max + 1) ** 2
    Yr = real_sph_harm(l_max, samples @ R)  # Y(R^-1 n) since R orthogonal
    D = np.zeros((K, K))
    for l in range(l_max + 1):
        s, e = l * l, (l + 1) * (l + 1)
        D[s:e, s:e] = Y_pinv_blocks[l] @ Yr[:, s:e]
    return D


def build_wigner_lut(
    l_max: int, n_theta: int = 32, n_phi: int = 64, n_samples: int = 512,
    seed: int = 0,
) -> np.ndarray:
    """LUT (n_theta*n_phi, K, K): rotation-to-z Wigner blocks per direction bin."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((n_samples, 3))
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    Y = real_sph_harm(l_max, s)
    Y_pinv_blocks = [
        np.linalg.pinv(Y[:, l * l : (l + 1) * (l + 1)]) for l in range(l_max + 1)
    ]
    K = (l_max + 1) ** 2
    lut = np.zeros((n_theta * n_phi, K, K), np.float32)
    for it in range(n_theta):
        theta = (it + 0.5) / n_theta * np.pi
        for ip in range(n_phi):
            phi = (ip + 0.5) / n_phi * 2 * np.pi - np.pi
            lut[it * n_phi + ip] = wigner_block(
                l_max, _rot_to_z(theta, phi), s, Y_pinv_blocks
            )
    return lut


def direction_bins(dirs: np.ndarray, n_theta: int, n_phi: int) -> np.ndarray:
    """Quantize unit directions into LUT bins (numpy mirror of the model's binning)."""
    theta = np.arccos(np.clip(dirs[:, 2], -1, 1))
    phi = np.arctan2(dirs[:, 1], dirs[:, 0])
    it = np.clip((theta / np.pi * n_theta).astype(np.int64), 0, n_theta - 1)
    ip = np.clip(((phi + np.pi) / (2 * np.pi) * n_phi).astype(np.int64), 0, n_phi - 1)
    return (it * n_phi + ip).astype(np.int32)


# static index sets for the m-restricted SO(2) convolution -------------------
def m_index_sets(l_max: int, m_max: int):
    """Row indices (into the K-dim SH axis) participating per |m|.

    Returns dict m -> (cos_rows, sin_rows) with sin_rows empty for m == 0.
    Row for (l, m) lives at l^2 + l + m.
    """
    out = {}
    for m in range(m_max + 1):
        cos_rows = [l * l + l + m for l in range(m, l_max + 1)]
        sin_rows = [l * l + l - m for l in range(m, l_max + 1)] if m > 0 else []
        out[m] = (np.asarray(cos_rows, np.int32), np.asarray(sin_rows, np.int32))
    return out
