"""The attention that training runs, against the JAX package's on the CPU:
``sdpa_dense``, ``sdpa_chunked`` and the ``sdpa_train`` dispatch, their
outputs and their gradients (``jax.grad`` of the reference's functions,
jitted), causal, windowed, with a query offset and non-causal, at chunks
small enough that tiles are skipped and the last tile is short; then one
train step of reduced qwen3-32b (gated FFN, RMSNorm, qk-norm, an untied
table) against the reference's jitted step.

Tolerances (fp32): outputs 2e-5 (tests/test_torch_models.py's attention
tolerance: sums in another order); gradients 1e-5 of each tensor's largest
gradient (a sum of Skv products of unit-scale terms, and for k and v a sum
over the queries and the heads of a group); the qwen3-32b step as
tests/test_torch_train.py holds starcoder2-3b's.  ``sdpa_dense`` called as
the encoder-decoder's cross attention calls it gives the same bits as the
formula it had before it took a window and an offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.models import attention as tattn

from torch_train_parity import _np, check_steps_against_reference

B, H, KH, D = 2, 4, 2, 16
# (sq, skv, causal, window, q_offset, q_chunk, kv_chunk)
CASES = {
    "causal": (20, 20, True, None, 0, 8, 8),
    "window": (20, 20, True, 5, 0, 8, 4),
    "window_offset": (8, 24, True, 6, 16, 8, 8),
    "bidirectional": (12, 20, False, None, 0, 8, 16),
}


def _inputs(sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, skv, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, skv, KH, D)).astype(np.float32)
    cot = rng.normal(size=(B, sq, H, D)).astype(np.float32)
    return q, k, v, cot


def _check(jfn, tfn, sq, skv):
    q, k, v, cot = _inputs(sq, skv)

    def out_and_grads(q, k, v, cot):
        out, vjp = jax.vjp(jfn, q, k, v)
        return out, vjp(cot)

    jout, jgrads = jax.jit(out_and_grads)(
        *(jnp.asarray(a) for a in (q, k, v, cot)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = tfn(tq, tk, tv)
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=2e-5, atol=2e-5)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads, strict=True):
        j = _np(j)
        np.testing.assert_allclose(_np(t.grad), j,
                                   atol=1e-5 * float(np.abs(j).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_and_chunked_match_jax(case):
    sq, skv, causal, window, q_offset, qc, kc = CASES[case]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _check(lambda q, k, v: jattn.sdpa_dense(q, k, v, **kw),
           lambda q, k, v: tattn.sdpa_dense(q, k, v, **kw), sq, skv)
    _check(lambda q, k, v: jattn.sdpa_chunked(q, k, v, q_chunk=qc,
                                              kv_chunk=kc, **kw),
           lambda q, k, v: tattn.sdpa_chunked(q, k, v, q_chunk=qc,
                                              kv_chunk=kc, **kw), sq, skv)


@pytest.mark.parametrize("threshold", [8, 2048])
def test_sdpa_train_dispatches_as_the_reference(threshold, monkeypatch):
    """Below the threshold the dense path, above it the chunked one with
    chunks of at least S/8, as the reference's ``sdpa`` picks them."""
    kw = dict(causal=True, window=None, q_offset=0,
              dense_threshold=threshold, q_chunk=4, kv_chunk=16)
    taken = []
    for name in ("sdpa_dense", "sdpa_chunked"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _f=fn, _n=name, **k:
                            taken.append((_n, k.get("q_chunk"))) or _f(*a, **k))
    _check(lambda q, k, v: jattn.sdpa(q, k, v, **kw),
           lambda q, k, v: tattn.sdpa_train(q, k, v, **kw), 40, 40)
    want = ("sdpa_dense", None) if threshold == 2048 else ("sdpa_chunked", 5)
    assert taken == [want]


def test_sdpa_dense_keeps_its_bits_for_its_callers():
    """The encoder-decoder's cross attention (no mask) and a causal call
    with no offset give the bits of the formula before the window and the
    offset were added."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(12, 12, seed=4))
    for causal in (False, True):
        qg = q.reshape(B, 12, KH, H // KH, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                              k.to(torch.float32)) * (D ** -0.5)
        if causal:
            qi = torch.arange(12)[:, None]
            ki = torch.arange(12)[None, :]
            logits = torch.where(qi >= ki, logits, tattn.NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        old = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(B, 12, H, D)
        assert torch.equal(tattn.sdpa_dense(q, k, v, causal=causal), old)


def test_qwen3_32b_step_matches_jax():
    check_steps_against_reference(1, "qwen3-32b")
