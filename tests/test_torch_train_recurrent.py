"""Training the recurrent families on the port against the JAX package on
the CPU: reduced recurrentgemma-2b (RG-LRU and local attention) and
reduced rwkv6-1.6b (chunked WKV, channel mix), fp32 compute, the
reference's state carried across as numpy arrays, one and two steps at
one and two microbatches against the reference's jitted
``make_train_step``; the gradients of ``wkv_chunked`` and ``rglru_scan``
against ``jax.grad`` of the reference's functions.

Tolerances:

* The train step: those of tests/test_torch_train.py
  (``torch_train_parity``).
* ``wkv_chunked`` and ``rglru_scan``: outputs rtol/atol 1e-4
  (tests/test_torch_recurrent.py's fp32 rule), every gradient within 1e-4
  of its own largest (fp32 sums over a chunk of 4 and a head of 4 in
  another order; the scan combines in another order than
  ``jax.lax.associative_scan``).  A strong-decay case (log w near -e^6
  a step, every decay 0 in fp32) must give finite gradients on both
  sides: the pairs off the causal triangle are masked before ``exp``, so
  their gradient is 0, not NaN.  There log w's true gradient lies below
  the rounding of the O(1) sums that carry it (both sides give a few
  ulps of noise, 1e-6 against r's O(1)), so each gradient is held within
  1e-4 of the largest gradient of any input instead of its own.
* Remat on and off: bit-equal gradients (the layer's no-grad forward runs
  the in-place pair tensor, its recompute the out-of-place one, and both
  give the same bits).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv

from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.checkpoint import _flatten_with_names

from torch_train_parity import (_configs, check_steps_against_reference,
                                reference_trajectory, torch_batch)

ARCHS = ["recurrentgemma-2b", "rwkv6-1.6b"]
B, S, H, N, W = 2, 11, 3, 4, 8


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, mb):
    check_steps_against_reference(mb, arch, steps=2)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _grads_close(got: dict, want: dict, own_scale: bool = True):
    """Each gradient within 1e-4 of its own largest, or of the largest of
    any input's (``own_scale`` False)."""
    want = {k: np.asarray(w) for k, w in want.items()}
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        scale = float(np.abs(w).max()) if own_scale else top
        np.testing.assert_allclose(g, w, atol=1e-4 * scale + 1e-30,
                                   err_msg=name)


def _torch_grads(fn, arrays: dict, weights):
    """Gradients of sum(out_i * weight_i) through ``fn`` in torch."""
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in arrays.items()}
    outs = fn(**leaves)
    loss = sum(torch.sum(o * torch.from_numpy(w))
               for o, w in zip(outs, weights, strict=True))
    loss.backward()
    return [o.detach().numpy() for o in outs], {
        k: t.grad.numpy() for k, t in leaves.items()}


def _jax_grads(fn, arrays: dict, weights):
    def loss(arrs):
        outs = fn(**arrs)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights,
                                                  strict=True)), outs
    grads, outs = jax.jit(jax.grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    return [np.asarray(o) for o in outs], grads


@pytest.mark.parametrize("decay", ["mixed", "strong"])
def test_wkv_chunked_gradients_match_jax(decay):
    """S = 11 over chunks of 4 (a ragged last chunk of 3) from a carried
    state: the output and the final state, and the gradients of a loss
    through both in r, k, v, log w, u and the state."""
    arrays = {name: _normal((B, S, H, N), seed)
              for seed, name in enumerate(("r", "k", "v"), 20)}
    scale = 3.0 if decay == "mixed" else 0.1
    shift = 0.0 if decay == "mixed" else 6.0
    arrays["logw"] = -np.exp(np.clip(
        _normal((B, S, H, N), 23, scale) + shift, -12, 6)).astype(np.float32)
    arrays["u"] = _normal((H, N), 24)
    arrays["state"] = _normal((B, H, N, N), 25)
    weights = [_normal((B, S, H, N), 26), _normal((B, H, N, N), 27)]
    if decay == "strong":
        assert arrays["logw"].max() < -100.0
    fn_j = functools.partial(jrwkv.wkv_chunked, chunk=4)
    fn_t = functools.partial(trwkv.wkv_chunked, chunk=4)
    outs_t, got = _torch_grads(fn_t, arrays, weights)
    outs_j, want = _jax_grads(fn_j, arrays, weights)
    for o_t, o_j in zip(outs_t, outs_j, strict=True):
        np.testing.assert_allclose(o_t, o_j, rtol=1e-4, atol=1e-4)
    _grads_close(got, want, own_scale=decay == "mixed")


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan_gradients_match_jax(carried):
    """The scan over S = 11 steps (with and without a carried state): h and
    h_last, and the gradients of a loss through both in x, r, i, the raw
    Lambda and h0.  Some gates r lie near 0, where a = exp(-8 softplus(L)
    r) is near 1 and the reference's sqrt(-expm1(2 log a)) has a large
    gradient; the port keeps that form."""
    arrays = {"x": _normal((B, S, W), 30),
              "r": 1 / (1 + np.exp(-_normal((B, S, W), 31, 4.0))),
              "i": 1 / (1 + np.exp(-_normal((B, S, W), 32))),
              "lam": _normal((W,), 33)}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    assert arrays["r"].min() < 1e-3
    if carried:
        arrays["h0"] = _normal((B, W), 34)
    weights = [_normal((B, S, W), 35), _normal((B, W), 36)]
    outs_t, got = _torch_grads(trglru.rglru_scan, arrays, weights)
    outs_j, want = _jax_grads(jrglru.rglru_scan, arrays, weights)
    for o_t, o_j in zip(outs_t, outs_j, strict=True):
        np.testing.assert_allclose(o_t, o_j, rtol=1e-4, atol=1e-4)
    _grads_close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bit_equal(arch):
    """One microbatch's gradients with remat on and off are bit-equal."""
    _, tcfg = _configs(arch)
    states, _ = reference_trajectory(1, arch)
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state = tloop.train_state_from_numpy(cfg, states[0], device="cpu")
        loss_fn = tloop.make_loss_fn(tbuild_model(cfg, device="cpu"),
                                     tloop.TrainConfig())
        loss, _ = loss_fn(state.params, torch_batch(arch, 0))
        loss.backward()
        grads.append(_flatten_with_names(
            topt.tree_map(lambda p: p.grad, state.params)))
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
