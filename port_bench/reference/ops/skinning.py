"""Linear-blend skinning as a dense bone-palette matmul.

Port of `simple_mmd_renderer_tpu/ops/skinning.py`. The static 4-wide weight
table becomes a dense [N, B] matrix W once at load (`build_weight_matrix`,
NumPy, copied from the reference), and each frame blends

    blended[N, 12] = W @ palette[B, 12]
    pos' = blended_rot @ (pos + morph) + blended_trans

The reference computes the blend with `jnp.dot` outside any Pallas kernel,
so here it is `torch.matmul` in float32 (the package switches TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch


def build_weight_matrix(skin_bones: np.ndarray, skin_weights: np.ndarray,
                        n_bones: int, dtype=np.float32) -> np.ndarray:
    """[N,4] sparse tables -> dense [N, B] weight matrix (host, once)."""
    n = skin_bones.shape[0]
    w = np.zeros((n, n_bones), np.float32)
    rows = np.repeat(np.arange(n), 4)
    cols = skin_bones.reshape(-1)
    vals = skin_weights.reshape(-1)
    np.add.at(w, (rows, np.clip(cols, 0, n_bones - 1)), vals)
    return w.astype(dtype)


def skin_matmul(weight_matrix, skin_mats, positions, vertex_offsets, normals):
    """-> (pos' [N,3], nrm' [N,3]). weight_matrix: [N,B]; skin_mats:
    [B,4,4]; the blend accumulates in float32. For a crowd, skin_mats
    [I,B,4,4] and vertex_offsets [I,N,3] against the shared weights, mesh
    and normals give [I,N,3] each, the blend as one batched product."""
    palette = skin_mats[..., :3, :4].reshape(
        skin_mats.shape[:-2] + (12,)).to(torch.float32)
    blended = weight_matrix.to(torch.float32) @ palette       # [..,N,12]
    m = blended.reshape(blended.shape[:-1] + (3, 4))
    p = positions + vertex_offsets
    out_pos = torch.einsum("...nij,...nj->...ni", m[..., :3], p) + m[..., 3]
    out_nrm = torch.einsum("...nij,nj->...ni", m[..., :3], normals)
    return out_pos, out_nrm
