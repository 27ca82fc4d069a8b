"""Synthetic stand-ins for the paper's vector datasets (Table 4).

Port of the vector half of ``repro.data.pipeline``: correlated Gaussian
mixtures with each dataset's (n, d) and Bregman measure, made with numpy
from a seed.  The dataset's stream is seeded from ``zlib.crc32`` of its
name, which is the same in every process (the builtin ``hash`` of a
string is not), so a run can be repeated.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..core.bregman import get_family


@dataclasses.dataclass(frozen=True)
class VectorDatasetSpec:
    name: str
    n: int
    d: int
    measure: str          # bregman family alias
    paper_m: int          # the paper's reported partition count


PAPER_DATASETS = {
    "audio": VectorDatasetSpec("audio", 54_387, 192, "ed", 28),
    "fonts": VectorDatasetSpec("fonts", 745_000, 400, "isd", 50),
    "deep": VectorDatasetSpec("deep", 1_000_000, 256, "ed", 37),
    "sift": VectorDatasetSpec("sift", 11_164_866, 128, "ed", 22),
    "normal": VectorDatasetSpec("normal", 50_000, 200, "ed", 25),
    "uniform": VectorDatasetSpec("uniform", 50_000, 200, "isd", 21),
}


def dataset_seed(spec: VectorDatasetSpec, seed: int = 0) -> int:
    """The numpy seed of a dataset's stream."""
    return seed + zlib.crc32(spec.name.encode()) % (1 << 30)


def make_vectors(spec: VectorDatasetSpec, scale: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """Correlated mixture with the dataset's (n, d) scaled by ``scale``.

    k Gaussian blobs with low-rank covariance (inter-dim correlations for
    PCCP), folded positive, with per-cluster energy scales spanning ~6x —
    the non-negative, heterogeneous-magnitude shape of the paper's real
    feature sets.  The low-rank term is formed per blob, so no (n, d, rank)
    temporary is made (65 GB at Deep's size).
    """
    n = max(int(spec.n * scale), 64)
    d = spec.d
    rng = np.random.default_rng(dataset_seed(spec, seed))
    if spec.name == "uniform":
        data = rng.uniform(0.0, 100.0, (n, d))
    elif spec.name == "normal":
        data = rng.normal(size=(n, d))
    else:
        k = 16
        rank = max(d // 8, 4)
        centers = np.abs(rng.normal(size=(k, d))) * 2.0
        # per-cluster x per-dim energy pattern: heterogeneity must show up
        # INSIDE every subspace for the per-subspace bounds to discriminate
        scales = (rng.uniform(0.5, 3.0, size=(k, 1))
                  * np.exp(0.5 * rng.normal(size=(k, d))))
        mix = rng.integers(0, k, n)
        factors = rng.normal(size=(k, d, rank)) / np.sqrt(rank)
        z = rng.normal(size=(n, rank))
        data = centers[mix]
        for c in range(k):
            rows = np.flatnonzero(mix == c)
            data[rows] += z[rows] @ factors[c].T
        data += 0.1 * rng.normal(size=(n, d))
        data = np.abs(data) * scales[mix]
    fam = get_family(spec.measure)
    if fam.name in ("itakura_saito", "burg", "shannon"):
        data = np.abs(data) + 0.1
    if fam.name == "exponential":
        # keep e^x terms in a numerically sane band: the tuple-split form
        # fx - x.grad + c_y cancels catastrophically in f32 beyond |x|~6
        data = 5.0 * data / max(np.percentile(data, 99.5), 1e-9)
    return data.astype(np.float32)


def make_queries(spec: VectorDatasetSpec, num: int = 50, scale: float = 1.0,
                 data_seed: int = 0, seed: int = 1,
                 data: np.ndarray | None = None) -> np.ndarray:
    """The paper's protocol: ``num`` points drawn from the dataset without
    replacement.  Pass ``data`` (the output of :func:`make_vectors` for the
    same spec, scale and seed) to skip making it again."""
    if data is None:
        data = make_vectors(spec, scale=scale, seed=data_seed)
    rng = np.random.default_rng(seed)
    idx = rng.choice(data.shape[0], size=min(num, data.shape[0]),
                     replace=False)
    return data[idx]
