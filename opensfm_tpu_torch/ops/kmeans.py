"""Lloyd k-means and nearest-word assignment on torch tensors.

Port of `opensfm_tpu.ops.kmeans` (vocabulary training for BoW and VLAD):
squared distances as the reference's float32 expression
|x|^2 - 2 x c^T + |c|^2, with the product a plain `torch.matmul` (the
JAX package computes it outside any Pallas kernel, in jnp).  Both entry
points work in chunks of rows, so no [N, K] matrix of a whole image
against a 10,000-word vocabulary (or a one-hot of 200,000 x 1,024) is held
at once.  Every sum runs in a fixed order: the per-cluster sums are the
reference's one-hot product, chunk by chunk in row order, never an atomic
`index_add_`, so two runs on one card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from opensfm_tpu_torch import resolve_device

# Distance-matrix entries per chunk of rows (64 MB of float32, 128 MB more
# for the int64 ranking keys of `assign_words_topk`).
CHUNK_ENTRIES = 1 << 24


def _rows_per_chunk(n_centers: int) -> int:
    return max(1, CHUNK_ENTRIES // max(n_centers, 1))


def _sqdist(x: torch.Tensor, centers: torch.Tensor,
            c2: torch.Tensor) -> torch.Tensor:
    """The reference's float32 squared distances [n, K]."""
    return (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ centers.T)
            + c2[None, :])


def _lloyd(x: torch.Tensor, centers: torch.Tensor,
           iterations: int) -> torch.Tensor:
    k = centers.shape[0]
    step = _rows_per_chunk(k)
    for _ in range(iterations):
        c2 = torch.sum(centers * centers, dim=1)
        counts = torch.zeros(k, dtype=x.dtype, device=x.device)
        sums = torch.zeros_like(centers)
        for s in range(0, x.shape[0], step):
            xs = x[s:s + step]
            assign = torch.argmin(_sqdist(xs, centers, c2), dim=1)
            one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
            counts += torch.sum(one_hot, dim=0)
            sums += one_hot.T @ xs
        new_centers = sums / torch.clamp_min(counts[:, None], 1.0)
        # Keep empty clusters where they were.
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    return centers


def train_kmeans(descriptors: np.ndarray, n_clusters: int,
                 iterations: int = 30, seed: int = 42,
                 device=None) -> np.ndarray:
    """K-means centres [n_clusters, D] float32 for vocabulary training: the
    reference's host draws (tiling when there are fewer points than
    centres, then `default_rng(seed).choice` of the initial centres), then
    `iterations` Lloyd steps on `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    x = np.asarray(descriptors, dtype=np.float32)
    rng = np.random.default_rng(seed)
    if len(x) < n_clusters:
        reps = int(np.ceil(n_clusters / max(len(x), 1)))
        x = np.tile(x, (reps, 1))
    init = x[rng.choice(len(x), n_clusters, replace=False)]
    centers = _lloyd(torch.as_tensor(x, device=dev),
                     torch.as_tensor(init, device=dev), iterations)
    return centers.cpu().numpy()


def _ranking_keys(d: torch.Tensor) -> torch.Tensor:
    """int64 keys that order float32 distances ascending and, at equal
    distances, the lower column first: the order of `lax.top_k(-d, k)`."""
    bits = d.contiguous().view(torch.int32)
    # Flip the magnitude bits of negative floats: signed integer order is
    # then the float order.
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
    return bits.to(torch.int64) * (1 << 32) + col[None, :]


def assign_words_topk(descriptors: torch.Tensor, centers: torch.Tensor,
                      k: int = 1) -> torch.Tensor:
    """Indices [N, k] int64 of the k nearest words per descriptor, nearest
    first, ties to the lower word index; float32 tensors on one device."""
    x = descriptors.to(torch.float32)
    c = centers.to(torch.float32)
    c2 = torch.sum(c * c, dim=1)
    step = _rows_per_chunk(c.shape[0])
    out = [torch.topk(_ranking_keys(_sqdist(x[s:s + step], c, c2)), k,
                      dim=1, largest=False, sorted=True).values
           for s in range(0, x.shape[0], step)]
    if not out:
        return torch.zeros((0, k), dtype=torch.int64, device=x.device)
    return torch.cat(out) & 0xFFFFFFFF
