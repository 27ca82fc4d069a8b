"""The port's training slice against the JAX package's on the CPU: the token
stream, the schedule, the clip and AdamW, the chunked loss and its
gradients, and the train step on reduced starcoder2-3b (its parameters
carried across from the reference as numpy arrays) for one and three steps
with one and two microbatches, a cross-restart (the reference trains two
steps, the port the next two), remat on and off, and kernel #10 kept off
every training path.  The JAX side runs its own jitted ``make_train_step``
on a one-device mesh.

Tolerances, all in fp32 compute:

* Token batches: bit-equal (the same numpy generator).
* The schedule: rtol 1e-6 (fp32 ``cos`` of two libraries); the clip and
  AdamW on a random tree: rtol 1e-6, atol 1e-7 (fp32 ``pow`` and ``sqrt``
  an ulp apart; every other operation in the reference's order).
* The chunked loss: rtol 1e-6 on the loss, 1e-5 against a dense loss (the
  reference test's bound); gradients atol 1e-6 of a unit scale (sums of 32
  fp32 terms in another order).
* The train step: the loss and the nll within rtol 1e-5; the gradients
  within 1e-4 of each leaf's largest gradient (fp32 sums over d = 64 and
  32 positions, through two layers, a LayerNorm and a 512-row tied table,
  in another order); the moments after one and three steps within that
  share of each leaf's largest, the parameters within 1e-6 + 1e-5 of
  themselves plus what that gradient error can move AdamW's step
  (``assert_state_close``).  bf16 compute is reported against the fp32
  reference: loss within 2e-2 (about five bf16 roundings of a sum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.models.registry import build_model as jbuild_model
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.checkpoint import _flatten_with_names

from torch_train_parity import (_configs, _np, _stream, assert_state_close,
                                check_steps_against_reference, port_steps,
                                reference_trajectory)

# ---------------------------------------------------------------------------
# Token stream, optimizer, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mrope", [False, True])
def test_token_batches_are_bit_equal(mrope):
    kw = dict(vocab_size=300, seq_len=24, global_batch=3, seed=5)
    for step in (0, 1, 17):
        want = jdata.token_batch(jdata.TokenStreamConfig(**kw), step,
                                 mrope=mrope)
        got = tdata.token_batch(tdata.TokenStreamConfig(**kw), step,
                                device="cpu", mrope=mrope)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(7,)).astype(np.float32)},
                       {"b": rng.normal(size=(7,)).astype(np.float32)}],
            "t": rng.normal(size=(3, 2, 4)).astype(np.float32)}


def _torch_tree(tree):
    return topt.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def test_schedule_clip_and_adamw_match_jax():
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20,
                  grad_clip_norm=0.5)
    jcfg, tcfg = jopt.OptimizerConfig(**cfg_kw), topt.OptimizerConfig(**cfg_kw)
    for s in (0, 1, 3, 4, 11, 20, 25):
        np.testing.assert_allclose(
            float(topt.schedule(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(jopt.schedule(jcfg, jnp.int32(s))), rtol=1e-6)
    params = _tree(0)
    grads = [_tree(1 + i) for i in range(3)]
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch_tree(params)
    js = jopt.init_state(jp)
    ts = topt.init_state(tp)
    japply = jax.jit(jopt.apply_updates, static_argnums=3)
    for g in grads:
        jp, js, jstats = japply(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tstats = topt.apply_updates(tp, _torch_tree(g), ts, tcfg)
        for k in ("lr", "grad_norm", "param_norm"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6, err_msg=k)
        for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j),
                            strict=True):
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    # the clip alone: scaled in place, the norm before clipping returned
    g = _torch_tree(grads[0])
    clipped, norm = topt.clip_by_global_norm(g, 0.5)
    jclipped, jnorm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads[0]), 0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert clipped["w"] is g["w"]
    for a, b in zip(jax.tree.leaves(clipped), jax.tree.leaves(jclipped),
                    strict=True):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("z_weight", [0.0, 1e-4])
def test_chunked_cross_entropy_and_grads_match_jax(z_weight):
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 40, 16, 97
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    table = rng.normal(size=(v, d)).astype(np.float32)

    def jloss(h, t):
        return jlosses.chunked_cross_entropy(h, jnp.asarray(labels), t,
                                             chunk=16, z_weight=z_weight)

    (jl, jm), (jgh, jgt) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(hidden),
                                              jnp.asarray(table))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    tl, tm = tlosses.chunked_cross_entropy(th, torch.from_numpy(labels), tt,
                                           chunk=16, z_weight=z_weight)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for k in ("nll", "z_loss", "accuracy"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(_np(th.grad), _np(jgh), atol=1e-6)
    np.testing.assert_allclose(_np(tt.grad), _np(jgt), atol=1e-6)
    # against a dense loss over the whole sequence at once
    logits = torch.from_numpy(hidden) @ torch.from_numpy(table).T
    dense = torch.mean(torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0])
    np.testing.assert_allclose(float(tm["nll"].detach()), float(dense), rtol=1e-5)
    assert float(tl.detach()) >= float(tm["nll"].detach())


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def test_gradients_match_jax_and_remat_is_bit_equal():
    """One microbatch's gradients against ``jax.grad`` of the reference's
    loss; the port's with remat on and off are bit-equal."""
    jcfg, tcfg = _configs()
    states, _ = reference_trajectory(1)
    jstream, tstream = _stream()
    jbundle = jbuild_model(jcfg)
    jfn = jax.jit(jax.value_and_grad(
        jloop.make_loss_fn(jbundle, jloop.TrainConfig()), has_aux=True))
    (jl, jm), jg = jfn(jax.tree.map(jnp.asarray, states[0].params),
                       jdata.token_batch(jstream, 0))
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        state = tloop.train_state_from_numpy(cfg, states[0], device="cpu")
        loss_fn = tloop.make_loss_fn(tbuild_model(cfg, device="cpu"),
                                     tloop.TrainConfig())
        tl, tm = loss_fn(state.params, tdata.token_batch(tstream, 0,
                                                         device="cpu"))
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        grads[remat] = _flatten_with_names(
            topt.tree_map(lambda p: p.grad, state.params))
    want = _flatten_with_names(jg)
    assert set(grads[True]) == set(want)
    for name, w in want.items():
        w = _np(w)
        np.testing.assert_allclose(_np(grads[True][name]), w,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-9,
                                   err_msg=name)
        assert torch.equal(grads[True][name], grads[False][name]), name


@pytest.mark.parametrize("mb", [1])
def test_train_steps_match_jax(mb):
    """One and three steps of one microbatch (two: in
    test_torch_train_microbatches.py) against the reference's jitted
    step."""
    check_steps_against_reference(mb)


def test_cross_restart_continues_the_reference():
    """The reference trains two steps; its state carried across, the port's
    steps 3 and 4 match the reference's."""
    _, tcfg = _configs()
    states, ref_metrics = reference_trajectory(1)
    state, metrics = port_steps(tcfg, states[2], 2, 4, 1)
    assert int(state.opt.step) == 4
    for got, want in zip(metrics, ref_metrics[2:]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_state_close(state, states[2:], [m["lr"] for m in ref_metrics[2:]])


def test_bf16_step_is_reported_against_the_fp32_reference(capsys):
    _, tcfg = _configs()
    states, ref_metrics = reference_trajectory(1)
    cfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    _, metrics = port_steps(cfg, states[0], 0, 1, 1)
    err = abs(metrics[0]["loss"] - ref_metrics[0]["loss"])
    with capsys.disabled():
        print(f"\nbf16 port loss {metrics[0]['loss']:.6f} against the fp32 "
              f"reference's {ref_metrics[0]['loss']:.6f} (|diff| {err:.3g})")
    assert err <= 2e-2 * abs(ref_metrics[0]["loss"])


def test_training_never_reaches_kernel_10(monkeypatch):
    """#10's dispatcher raises under grad on either device; a train step
    calls neither it nor its plain version, while a no-grad forward still
    does."""
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, q, q)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).shape == q.shape
    calls = []
    monkeypatch.setattr(ref, "flash_attention",
                        lambda *a, **k: calls.append(1) or
                        pytest.fail("training reached #10's plain version"))
    _, tcfg = _configs()
    states, _ = reference_trajectory(1)
    port_steps(tcfg, states[0], 0, 1, 2)
    assert calls == []
    bundle = tbuild_model(tcfg, device="cpu")
    _, tstream = _stream()
    batch = tdata.token_batch(tstream, 0, device="cpu")
    with pytest.raises(pytest.fail.Exception):
        bundle.forward_train(bundle.init(0), batch)
    assert calls == [1]


def test_train_step_refuses_what_it_does_not_train():
    """Every config the reference builds trains (each family's parity is in
    tests/test_torch_train_{moe,recurrent,encdec,vlm}.py); a remat policy
    that is not ported and a config type that does not exist are
    refused."""
    for arch in tconfigs.ARCH_IDS:
        bundle = tbuild_model(tconfigs.get_reduced(arch), device="cpu")
        tloop.make_train_step(bundle, tloop.TrainConfig())
    _, tcfg = _configs(remat_policy="dots")
    with pytest.raises(ValueError, match="not ported"):
        tloop.make_train_step(tbuild_model(tcfg, device="cpu"),
                              tloop.TrainConfig())
    with pytest.raises(TypeError, match="unknown config type"):
        tloop.check_trainable(object())
