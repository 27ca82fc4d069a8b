"""Deterministic synthetic data: LM token batches and the paper's vector
sets (port of ``repro.data.pipeline``).

Every token batch is a pure function of ``(seed, step)``: nothing is
consumed from a stateful iterator, so a restart from step k replays the
same stream, which makes a checkpoint restart bit-exact.  On a mesh each
rank makes only its own rows (a row is a function of its global index),
and the batch dim lies where the rules table puts the logical ``batch``
axis (the default's ``pod`` and ``data``), as the reference assembles it
shard-wise; the stream does not depend on the mesh shape.

The vector half makes correlated Gaussian mixtures with each dataset's
(n, d) and Bregman measure, with numpy from a seed.  The dataset's stream
is seeded from ``zlib.crc32`` of its name, which is the same in every
process (the builtin ``hash`` of a string is not), so a run can be
repeated.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.bregman import get_family
from ..device import resolve_device
from ..dist import sharding as shd


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the LM has something to learn
    num_patterns: int = 512
    pattern_len: int = 16


def _batch_np(cfg: TokenStreamConfig, step: int, rows: np.ndarray):
    """The given global row indices of batch ``step``, (len(rows),
    seq_len + 1) int32 (pure; the reference's generator, draw for draw)."""
    out_tok = np.empty((len(rows), cfg.seq_len + 1), np.int32)
    pat_rng = np.random.default_rng(cfg.seed ^ 0x5EED)
    patterns = pat_rng.integers(
        0, cfg.vocab_size, (cfg.num_patterns, cfg.pattern_len))
    for i, r in enumerate(rows):
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131_071 + int(r))
        seq = []
        while len(seq) < cfg.seq_len + 1:
            pid = int(rng.integers(cfg.num_patterns))
            seq.extend(patterns[pid])
            if rng.random() < 0.1:  # noise token breaks pure copying
                seq.append(int(rng.integers(cfg.vocab_size)))
        out_tok[i] = seq[: cfg.seq_len + 1]
    return out_tok


def batch_placements(b: int, mesh, rules=None) -> tuple:
    """Placements of a tensor whose dim 0 is a batch of ``b`` rows: the
    logical ``batch`` axis resolved by ``rules`` (``dist.sharding``'s
    tables; the default's ``pod`` and ``data``), every other dim
    replicated, as the reference assembles a token batch."""
    return shd.placements(shd.spec_for_shape(("batch",), (b,), mesh, rules),
                          mesh)


def local_rows(b: int, mesh, placements) -> np.ndarray:
    """This rank's global rows of a batch of ``b`` in ``placements``: one
    block of consecutive rows, the blocks in the order of the rank's
    coordinates over the mesh dims that shard dim 0, as DTensor splits
    it."""
    block, blocks = 0, 1
    for i, (pl, coord) in enumerate(zip(placements, mesh.get_coordinate(),
                                        strict=True)):
        if pl.is_shard(0):
            size = mesh.size(i)
            block, blocks = block * size + coord, blocks * size
    per = b // blocks
    return np.arange(block * per, (block + 1) * per)


def token_batch(cfg: TokenStreamConfig, step: int, device="cuda",
                mrope: bool = False, mesh=None, rules=None) -> dict:
    """Batch ``step`` as int32 tensors on ``device``: tokens and labels
    (B, S), the labels the tokens shifted by one, and positions (B, S), or
    (B, S, 3) with ``mrope``.  With ``mesh``, DTensors of the global batch
    in :func:`batch_placements` under ``rules``, each rank making only
    its rows (:func:`local_rows`)."""
    dev = resolve_device(device)
    s = cfg.seq_len
    if mesh is None:
        rows = np.arange(cfg.global_batch)
    else:
        sh = batch_placements(cfg.global_batch, mesh, rules)
        rows = local_rows(cfg.global_batch, mesh, sh)
    b = len(rows)
    toks = torch.from_numpy(_batch_np(cfg, step, rows)).to(dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    if mrope:
        pos = pos[..., None].expand(b, s, 3)
    pos = pos.contiguous()
    if mesh is not None:
        toks = DTensor.from_local(toks, mesh, sh)
        pos = DTensor.from_local(pos, mesh, sh)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "positions": pos}


# ---------------------------------------------------------------------------
# Paper vector datasets (Table 4 stand-ins)
# ---------------------------------------------------------------------------


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
