"""CUDA Gram kernel of the PCCP correlation matrix (paper §5.2).

:func:`pccp_gram` is the body of ``src/repro/kernels/pccp_corr.py::
pccp_correlation``: ``xc^T @ xc`` for centred rows xc (n, d) fp32, summed
over n in fp32 with no TF32 (``csrc/pccp_corr.cu``).  The centring, std,
scaling, ``abs`` and zeroed diagonal around it are torch operations in
``ops.pccp_correlation``, as the JAX wrapper keeps them outside its
``pallas_call``.  Bound by operations on the H100 (n·d·(d+1) fp32 FLOPs:
only the 128 × 128 tiles on and above the diagonal are computed, and
mirrored).

The host decides the launch (:func:`schedule`): the list of upper tiles,
and a split of n into chunks so that tiles × chunks blocks fill whole waves
of the blocks the card holds at once, no chunk longer than
``MAX_CHUNK_ROWS`` where ``MAX_SPLITS`` allows.  Each block writes a partial tile to
a (splits, d, d) scratch buffer and a second kernel sums the partials in
chunk order, so the result is deterministic and symmetric bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import _build

# Launches in this process (read and reset by chip_smoke.py).
launches = 0

TILE = 128          # output tile edge (csrc/pccp_corr.cu)
ROW_STEP = 16       # rows a pipeline step; a chunk is a multiple of it
MAX_SPLITS = 8      # scratch of at most 8 partial Grams
MIN_CHUNK_ROWS = 1024   # fewer rows a block would not amortise its tile
# The longest chain of rows one block sums in fp32.  A block adds its rows
# one after another, so the rounding of a long chain drifts in one
# direction where many rows repeat: at 65,472 keys of 8192 (a quarter of
# them one repeated row) one chain of all n rows strayed 1.37 times the
# limit chip_smoke.py holds it to from the float64 Gram on an H100,
# cuBLAS 0.47.
MAX_CHUNK_ROWS = 16384

_slots: dict[int, int] = {}


def upper_tiles(d: int) -> list[tuple[int, int]]:
    """The (row, column) index of every 128 × 128 tile of a (d, d) Gram on
    or above the diagonal, row by row: block x of the grid takes entry x."""
    t = -(-d // TILE)
    return [(i, j) for i in range(t) for j in range(i, t)]


def tile_index(d: int, device) -> torch.Tensor:
    """``upper_tiles(d)`` as a (num_tiles, 2) int32 tensor, made on
    ``device`` by a kernel: a copy from the host would wait for the
    card's queue to drain before the Gram is launched."""
    t = -(-d // TILE)
    return (torch.triu_indices(t, t, device=device).T
            .to(torch.int32).contiguous())


def chunk_rows(n: int, splits: int) -> int:
    """Rows of each of ``splits`` chunks of n (the last may be shorter or
    empty): n / splits rounded up to a whole pipeline step."""
    per = -(-max(n, 1) // splits)
    return -(-per // ROW_STEP) * ROW_STEP


def split_count(tiles: int, n: int, slots: int) -> int:
    """The chunks of n to cut the work into, for ``tiles`` output tiles on
    a card that runs ``slots`` blocks at once.  A block's time goes with
    its rows, so the launch takes about ceil(tiles·S / slots) waves of
    ``chunk_rows(n, S)`` rows: the S in 1..MAX_SPLITS that minimises that
    product, each chunk at least MIN_CHUNK_ROWS rows (S = 1 always
    allowed) and at most MAX_CHUNK_ROWS where MAX_SPLITS chunks reach
    it, the smallest S on a tie."""
    least = min(MAX_SPLITS, -(-max(n, 1) // MAX_CHUNK_ROWS))
    best, best_cost = least, None
    for s in range(least, MAX_SPLITS + 1):
        rows = chunk_rows(n, s)
        if s > 1 and rows < MIN_CHUNK_ROWS:
            break
        cost = math.ceil(tiles * s / slots) * rows
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def schedule(n: int, d: int, slots: int) -> tuple[list, int, int]:
    """(upper tiles, splits, rows per chunk) of one Gram launch."""
    tiles = upper_tiles(d)
    splits = split_count(len(tiles), n, slots)
    return tiles, splits, chunk_rows(n, splits)


def _device_slots(dev: torch.device) -> int:
    if dev.index not in _slots:
        slots = _build.library().brk_pccp_slots(dev.index)
        if slots < 0:
            _build.check(-slots, "pccp_gram occupancy")
        if slots == 0:
            raise RuntimeError("pccp_gram: no block of the Gram kernel fits "
                               "on an SM")
        _slots[dev.index] = slots
    return _slots[dev.index]


def pccp_gram(xc: torch.Tensor) -> torch.Tensor:
    """(d, d) fp32 Gram matrix of a contiguous (n, d) fp32 CUDA tensor."""
    global launches
    if xc.ndim != 2:
        raise ValueError(f"xc must be (n, d), got {tuple(xc.shape)}")
    n, d = xc.shape
    _build.expect(xc, "xc", (n, d))
    dev = xc.device
    gram = torch.empty((d, d), dtype=torch.float32, device=dev)
    if d == 0:
        return gram
    tiles, splits, rows = schedule(n, d, _device_slots(dev))
    scratch = torch.empty((splits, d, d), dtype=torch.float32, device=dev)
    tile_ids = tile_index(d, dev)
    err = _build.library().brk_pccp_gram(
        xc.data_ptr(), gram.data_ptr(), scratch.data_ptr(),
        tile_ids.data_ptr(), len(tiles), n, d, splits, rows, dev.index,
        _build.stream_of(dev))
    _build.check(err, "pccp_gram")
    launches += 1
    return gram
