"""The arithmetic of the tensor-core kernels, on the CPU (no kernel is built).

Kernel #10 in bf16 (``csrc/flash_attention_wgmma.cu``) is emulated in torch
as it tiles: 64-row q tiles (one warpgroup each) inside 128-row blocks,
64-key kv tiles from the block's reach, a tile skipped where none of the
tile's rows reaches it, fp32 scores from exact bf16 products, fp32 m and l
on the JAX kernel's update rule, P into the product as two bf16 halves
(``P_hi + P_lo``), the output rounded once to bf16.  On seeded numpy inputs
it is held:

* against the JAX package's Pallas kernel in interpret mode (bf16 in and
  out): two roundings to bf16 of nearly the same fp32 value differ by at
  most one bf16 step, ``2^-7 |want| + 1e-5``;
* against the port's plain version on fp32 upcasts within ``2^-8 |want| +
  1e-5``, the limit chip_smoke.py holds the kernel to (half a bf16 step:
  the output's own rounding);
* and a kernel that rounds P to bf16 once, as SDPA does, is shown to break
  that limit at the model's head dim.

Kernel #9's host-side schedule (``kernels/pccp_corr.py``): every tile on or
above the diagonal is launched once, every row of n falls in one chunk, no
chunk is longer than ``MAX_CHUNK_ROWS``, and the split fills the card's
waves.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash

from repro_torch.kernels import pccp_corr, ref

# The kernel's tiles (csrc/flash_attention_wgmma.cu).
BQ, WG_ROWS, BKV = 128, 64, 64
NEG_INF = -1e30

# tests/test_kernels.py::test_flash_attention's seven cases, then the
# model's head dim at S = 256: (b, h, kh, sq, skv, d, causal, window).
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),
    (1, 8, 2, 64, 64, 32, True, None),
    (2, 4, 1, 32, 32, 16, True, None),
    (1, 4, 4, 64, 64, 32, False, None),
    (1, 4, 2, 64, 64, 32, True, 16),
    (2, 4, 2, 1, 96, 32, True, None),
    (1, 2, 2, 48, 48, 32, True, None),
    (1, 4, 2, 256, 256, 128, True, None),
]


def emulate(q, k, v, *, causal=True, window=None, split=True):
    """The bf16 kernel's arithmetic: q (B, H, Sq, D), k/v (B, KH, Skv, D)
    bf16 -> (B, H, Sq, D) bf16.  ``split=False`` feeds P to the product
    rounded to bf16 once."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    rep = h // kh
    scale = 1.0 / float(d) ** 0.5
    off = skv - sq
    pad = -skv % BKV + BKV                 # TMA zero-fills past Skv
    qf = q.float()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf = kf.repeat_interleave(rep, 1)
    vf = vf.repeat_interleave(rep, 1)
    out = torch.zeros((b, h, sq, d), dtype=torch.float32)
    for q0 in range(0, sq, BQ):
        kv_end = min(skv, min(q0 + BQ, sq) + off) if causal else skv
        kv_begin = max(0, q0 + off - window + 1) if window else 0
        kv_begin -= kv_begin % BKV
        for w0 in range(q0, min(q0 + BQ, sq), WG_ROWS):
            rows = torch.arange(w0, w0 + WG_ROWS)
            qpos = rows + off
            w_hi = min(w0 + WG_ROWS, sq) - 1 + off
            w_end = min(skv, w_hi + 1) if causal else skv
            w_begin = max(0, w0 + off - window + 1) if window else 0
            qt = torch.nn.functional.pad(qf[:, :, w0:w0 + WG_ROWS],
                                         (0, 0, 0, w0 + WG_ROWS - min(
                                             w0 + WG_ROWS, sq)))
            m = torch.full((b, h, WG_ROWS, 1), NEG_INF)
            lsum = torch.zeros((b, h, WG_ROWS, 1))
            acc = torch.zeros((b, h, WG_ROWS, d))
            for k0 in range(kv_begin, kv_end, BKV):
                if not (k0 < w_end and k0 + BKV > w_begin):
                    continue
                kpos = torch.arange(k0, k0 + BKV)
                s = (qt @ kf[:, :, k0:k0 + BKV].transpose(-1, -2)) * scale
                ok = (kpos[None, :] < skv).expand(WG_ROWS, BKV)
                if causal:
                    ok = ok & (qpos[:, None] >= kpos[None, :])
                if window:
                    ok = ok & ((qpos[:, None] - kpos[None, :]) < window)
                s = torch.where(ok, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                lsum = alpha * lsum + p.sum(-1, keepdim=True)
                p_hi = p.bfloat16().float()
                acc = alpha * acc + p_hi @ vf[:, :, k0:k0 + BKV]
                if split:
                    p_lo = (p - p_hi).bfloat16().float()
                    acc = acc + p_lo @ vf[:, :, k0:k0 + BKV]
                m = m_new
            n_rows = min(w0 + WG_ROWS, sq) - w0
            res = acc / torch.clamp(lsum, min=1e-30)
            out[:, :, w0:w0 + n_rows] = res[:, :, :n_rows]
    return out.bfloat16()


def _inputs(b, h, kh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, sq, d), (b, kh, skv, d), (b, kh, skv, d))]
    jax_in = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    torch_in = [torch.from_numpy(a).bfloat16() for a in arrays]
    return jax_in, torch_in


def _over(got, want, rel):
    """The largest |got - want| as a share of rel·|want| + 1e-5."""
    limit = rel * want.abs() + 1e-5
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,window", FLASH_CASES)
def test_tensor_core_flash_arithmetic_keeps_the_fp32_kernels_limit(
        b, h, kh, sq, skv, d, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(b, h, kh, sq, skv, d, seed=sq + d)
    got = emulate(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want_fp32 = ref.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    assert _over(got, want_fp32, 2.0 ** -8) <= 1.0
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                          interpret=True)
    want_jax = torch.from_numpy(np.asarray(pallas, dtype=np.float32))
    assert _over(got, want_jax, 2.0 ** -7) <= 1.0


def test_one_bf16_rounding_of_p_breaks_the_limit_at_the_models_head_dim():
    """Causal, 4 heads on 2 KV heads, D = 128, S = 256: the split P stays
    within half a bf16 step of the fp32 output; P rounded once does not."""
    _, (q, k, v) = _inputs(1, 4, 2, 256, 256, 128, seed=7)
    want = ref.flash_attention(q.float(), k.float(), v.float(), causal=True)
    split = _over(emulate(q, k, v), want, 2.0 ** -8)
    single = _over(emulate(q, k, v, split=False), want, 2.0 ** -8)
    assert split <= 1.0 < single


@pytest.mark.parametrize("d", [100, 3072])
@pytest.mark.parametrize("n", [1, 1000, 65_472])
@pytest.mark.parametrize("slots", [132, 264])
def test_gram_schedule_covers_every_upper_tile_and_row_once(d, n, slots):
    tiles, splits, rows = pccp_corr.schedule(n, d, slots)
    t = math.ceil(d / pccp_corr.TILE)
    assert len(tiles) == len(set(tiles)) == t * (t + 1) // 2
    assert all(0 <= i <= j < t for i, j in tiles)
    assert 1 <= splits <= pccp_corr.MAX_SPLITS
    assert rows % pccp_corr.ROW_STEP == 0
    covered = np.zeros(n, dtype=int)
    for c in range(splits):
        covered[c * rows:min(n, (c + 1) * rows)] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("d", [384, 2048, 3072, 8192])
@pytest.mark.parametrize("slots", [132, 264])
def test_gram_chunks_are_at_most_the_longest_chain(d, slots):
    """65,472 rows (the datastore's keys) never go to one block as a single
    fp32 chain longer than MAX_CHUNK_ROWS, at any width; among the splits
    that keep that, the schedule's fills the waves best."""
    n = 65_472
    tiles, splits, rows = pccp_corr.schedule(n, d, slots)
    assert rows <= pccp_corr.MAX_CHUNK_ROWS
    allowed = [s for s in range(1, pccp_corr.MAX_SPLITS + 1)
               if pccp_corr.chunk_rows(n, s) <= pccp_corr.MAX_CHUNK_ROWS]

    def waves_rows(s):
        return math.ceil(len(tiles) * s / slots) * pccp_corr.chunk_rows(n, s)

    assert splits == min(allowed, key=lambda s: (waves_rows(s), s))


@pytest.mark.parametrize("d", [1, 100, 129, 3072])
def test_gram_tile_index_is_the_upper_tile_list(d):
    """The tile tensor the kernel reads, made on the device, lists the same
    tiles in the same order as the host schedule."""
    got = pccp_corr.tile_index(d, "cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert [tuple(t) for t in got.tolist()] == pccp_corr.upper_tiles(d)


def test_gram_split_fills_the_waves_at_the_datastore_shape():
    """300 upper tiles at two blocks an SM on 132 SMs: unsplit, the second
    wave holds 36 blocks; the chosen split predicts less time than any
    other within MAX_SPLITS."""
    n, d, slots = 65_472, 3072, 264
    tiles, splits, rows = pccp_corr.schedule(n, d, slots)
    assert len(tiles) == 300 and splits > 1

    def waves_rows(s):
        return math.ceil(300 * s / slots) * pccp_corr.chunk_rows(n, s)

    assert all(waves_rows(splits) <= waves_rows(s)
               for s in range(1, pccp_corr.MAX_SPLITS + 1))
    assert waves_rows(splits) < 0.6 * waves_rows(1)
