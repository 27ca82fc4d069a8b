"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; a
forest built by the JAX package reaches the port only as numpy arrays.
"""

import functools

import numpy as np

from repro.core.bregman import get_family
from repro.core.index import build_index as jax_build_index

import repro_torch.core.index as tidx

N, D, M, Q, K = 420, 16, 4, 4, 5
NUM_CLUSTERS = 8
POSITIVE = ("itakura_saito", "burg", "shannon")


def sample(family: str, shape, seed: int) -> np.ndarray:
    """Valid fp32 data for ``family`` (the reference's sampler, in numpy)."""
    raw = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    name = get_family(family).name
    if name in POSITIVE:
        return np.abs(raw) + np.float32(0.05)
    if name == "exponential":
        return np.clip(raw, -4.0, 4.0)
    return raw


def clustered(family: str, shape, seed: int, blobs: int = 6) -> np.ndarray:
    """Blobs of different magnitude, so the Theorem-3 prune rejects rows."""
    rng = np.random.default_rng(seed)
    n, d = shape
    centers = rng.uniform(0.2, 3.0, size=(blobs, d))
    x = centers[rng.integers(0, blobs, n)] + 0.05 * rng.normal(size=(n, d))
    name = get_family(family).name
    if name in POSITIVE:
        x = np.abs(x) + 0.05
    return x.astype(np.float32)


def filter_inputs(n: int, m: int, q: int, seed: int) -> tuple:
    """(alpha, sg, amin, gmax, qc, sd, qb) fp32 tables whose admit mask is
    mixed: each bound ``qb[j, i]`` sits at the quantile of its column's
    lower bounds that admits about half the rows over ``m`` subspaces, and
    column 0 ties row 0's lower bound exactly, so ``<=`` decides it."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    alpha = rng.normal(size=(n, m)).astype(f32)
    sg = np.abs(rng.normal(size=(n, m))).astype(f32)
    amin = rng.normal(size=(n, m)).astype(f32)
    gmax = np.abs(rng.normal(size=(n, m))).astype(f32)
    qc = rng.normal(size=(q, m)).astype(f32)
    sd = np.abs(rng.normal(size=(q, m))).astype(f32)
    # Rounded op by op, as every version of the admit test computes it.
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = np.quantile(lb, 1.0 - 0.5 ** (1.0 / m), axis=0).T.astype(f32)
    qb[:, 0] = lb[0, 0, :]
    return alpha, sg, amin, gmax, qc, sd, qb


@functools.lru_cache(maxsize=None)
def jax_forest(family: str):
    """(reference forest, data, queries) for one family, built once."""
    data = sample(family, (N, D), seed=0)
    queries = sample(family, (Q, D), seed=1)
    return jax_build_index(data, family, m=M, num_clusters=NUM_CLUSTERS,
                           seed=0), data, queries


def to_numpy(jforest) -> dict:
    return {f: np.asarray(getattr(jforest, f))
            for f in tidx.INTERCHANGE_FIELDS}


def to_port(jforest, device="cpu"):
    """The reference forest imported into the port through numpy."""
    return tidx.forest_from_numpy(
        to_numpy(jforest), family_name=jforest.family_name,
        partition_idx=jforest.partition.idx,
        partition_mask=jforest.partition.mask, d=jforest.partition.d,
        num_clusters=jforest.num_clusters, device=device)
