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
def jax_forest(family: str, quantize: bool = False):
    """(reference forest, data, queries) for one family, built once; with
    ``quantize`` the reference's int8 forest over the same data."""
    data = sample(family, (N, D), seed=0)
    queries = sample(family, (Q, D), seed=1)
    return jax_build_index(data, family, m=M, num_clusters=NUM_CLUSTERS,
                           seed=0, quantize=quantize), data, queries


@functools.lru_cache(maxsize=None)
def blob_forest(quantize: bool = False):
    """(reference forest, data, queries) over six Gaussian blobs 10 apart
    (squared Euclidean, N rows), where the Theorem-3 mask of a query near
    the first blobs admits some rows and rejects the others."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(size=(N // 6, D)) + 10.0 * j
                           for j in range(6)]).astype(np.float32)
    queries = data[[0, 40, 77, 150]] * np.float32(1.01)
    return jax_build_index(data, "squared_euclidean", m=M,
                           num_clusters=NUM_CLUSTERS, seed=0,
                           quantize=quantize), data, queries


def quant_inputs(n: int, m: int, seed: int) -> tuple:
    """Int8 codes (n, m) with their per-row (scale, zp): the codes reach
    -128 and 127, and row 1 is a constant row (scale 0, codes 0)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, size=(n, m)).astype(np.int8)
    codes[0, 0] = -128
    codes[-1, -1] = 127
    scale = rng.uniform(1e-3, 0.1, n).astype(np.float32)
    zp = rng.normal(size=n).astype(np.float32)
    if n > 1:
        codes[1] = 0
        scale[1] = 0.0
    return codes, scale, zp


def filter_inputs_quant(n: int, m: int, q: int, seed: int) -> tuple:
    """The operands of the int8 filter + prune kernels — four code tables
    (:func:`quant_inputs`; the corners' decode positive for sqrt_gamma) and
    the (q, M) query tables — as a tuple in the kernels' argument order.
    As in :func:`filter_inputs`, ``qb`` admits about half the rows, and
    column 0 ties row 0's decoded lower bound exactly."""
    f32 = np.float32
    tables = []
    for i in range(4):
        codes, scale, zp = quant_inputs(n, m, seed + i)
        if i in (1, 3):                      # sqrt_gamma: decode >= 0
            zp = np.abs(zp) + f32(128) * scale
        tables += [codes, scale, zp]
    rng = np.random.default_rng(seed + 4)
    qc = rng.normal(size=(q, m)).astype(f32)
    sd = np.abs(rng.normal(size=(q, m))).astype(f32)
    # The corners decoded and the bound formed op by op, each rounded.
    amin = tables[6].astype(f32) * tables[7][:, None] + tables[8][:, None]
    gmax = tables[9].astype(f32) * tables[10][:, None] + tables[11][:, None]
    lb = (amin[:, :, None] + qc.T[None]) - gmax[:, :, None] * sd.T[None]
    qb = np.quantile(lb, 1.0 - 0.5 ** (1.0 / m), axis=0).T.astype(f32)
    qb[:, 0] = lb[0, 0, :]
    return (*tables, qc, sd, qb)


def to_numpy(jforest) -> dict:
    return {f: np.asarray(getattr(jforest, f))
            for f in tidx.interchange_fields(jforest.storage)}


def to_port(jforest, device="cpu"):
    """The reference forest imported into the port through numpy."""
    return tidx.forest_from_numpy(
        to_numpy(jforest), family_name=jforest.family_name,
        partition_idx=jforest.partition.idx,
        partition_mask=jforest.partition.mask, d=jforest.partition.d,
        num_clusters=jforest.num_clusters, storage=jforest.storage,
        device=device)
