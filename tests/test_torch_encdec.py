"""The port's encoder-decoder (whisper-tiny) against the JAX package's on the
CPU: ``sinusoidal_positions``; reduced whisper-tiny's ``encode``,
``forward_train``, ``prefill`` (hidden states, every layer's self and
cross caches) and ``decode_step`` (logits, hidden states, caches) over
seeded non-zero frames; ``sdpa_dense``; the full config's parameter count;
the datastore's keys against the reference's ``build_datastore``; the
engine with the kNN-LM hook against the reference's engine, its tokens
and every sampling step's hooked logits; and slot isolation of the cross
caches.  The same numpy inputs, made from a seed, go to both packages; the
reference's parameters reach the port through ``params_from_numpy``.

Tolerance: everything computes in fp32 and is held to 1e-5 of the
reference's max |value| (sums in another order through two layers); the
greedy tokens compare equal.  Seeded whisper weights give degenerate
greedy tokens (one id over and over), so the hooked logits of every step
are compared too.  The JAX side runs under ``jax.jit``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.serve import knnlm as jknnlm

from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import knnlm as tknnlm

ARCH = "whisper-tiny"
VOCAB = 512
B, S, S_MAX, FRAMES, D = 2, 10, 16, 16, 64
_ONCE: dict = {}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, key=""):
    """|port - reference| within 1e-5 of the reference's max |value|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, key
    assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max()), key


@pytest.mark.parametrize("seq,d", [(1500, 384), (16, 64), (5, 2)])
def test_sinusoidal_positions_match_jax(seq, d):
    """Within 1e-5, plus the rounding of each fp32 angle: position x an
    inverse frequency from fp32 ``pow``, which the two libraries may round
    an ulp apart, so sin and cos of an angle near 1500 may differ by about
    4 eps32 x the angle (the float64 table's own angles)."""
    got = tlayers.sinusoidal_positions(seq, d)
    want = _np(jlayers.sinusoidal_positions(seq, d))
    half = d // 2
    ang = np.arange(seq)[:, None] / 10000.0 ** (
        np.arange(half) / max(half - 1, 1))[None, :]
    tol = 1e-5 + 4 * 2.0 ** -23 * np.concatenate([ang, ang], -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool((np.abs(got.numpy() - want) <= tol).all())
    exact = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    assert bool((np.abs(got.numpy() - exact) <= tol).all())


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_dense_matches_jax(causal):
    """Cross attention's plain math (GQA 2:1, 7 queries over 7 or 11
    keys): fp32 logits, softmax, the product with v."""
    rng = np.random.default_rng(int(causal))
    skv = 7 if causal else 11
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.sdpa_dense(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tattn.sdpa_dense(*map(torch.from_numpy, (q, k, v)), causal=causal)
    _close(got, want)


# ---------------------------------------------------------------------------
# Reduced whisper-tiny: encode, forward, prefill, decode
# ---------------------------------------------------------------------------

def _configs():
    return (dataclasses.replace(jconfigs.get_reduced(ARCH),
                                compute_dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_reduced(ARCH),
                                compute_dtype=torch.float32))


def _params():
    if "params" not in _ONCE:
        jcfg, _ = _configs()
        init = jax.jit(functools.partial(jed.init_params, jcfg))
        _ONCE["params"] = jax.tree.map(np.asarray,
                                       init(jax.random.PRNGKey(0)))
    return _ONCE["params"]


def _run(mod, cfg, params):
    """encode, forward_train, then prefill (hidden, self and cross caches)
    and two decode steps (logits, hidden, caches), as float32 numpy."""
    torch_side = mod is ted
    arr = torch.from_numpy if torch_side else jnp.asarray
    rng = np.random.default_rng(7)
    toks = rng.integers(1, VOCAB, (B, S)).astype(np.int32)
    frames = rng.normal(size=(B, FRAMES, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    fns = [functools.partial(f, cfg) for f in
           (mod.encode, mod.forward_train, mod.prefill, mod.decode_step)]
    if not torch_side:
        fns = [jax.jit(f) for f in fns]
    encode, forward, prefill, decode = fns
    out = {"encode": encode(params, arr(frames)),
           "forward": forward(params, arr(toks), arr(pos), arr(frames))[0]}
    caches = (mod.init_cache(cfg, B, S_MAX, device="cpu") if torch_side
              else mod.init_cache(cfg, B, S_MAX))
    out["prefill"], caches = prefill(params, arr(toks), arr(pos), caches,
                                     arr(np.zeros((B,), np.int32)),
                                     arr(frames))
    _cache_out(out, "prefill", caches)
    lengths = np.full((B,), S, np.int32)
    for step in range(2):
        lg, hd, caches = decode(params, arr(toks[:, step:step + 1].copy()),
                                arr(lengths[:, None].copy()), caches,
                                arr(lengths))
        out[f"decode_hidden{step}"], out[f"decode_logits{step}"] = hd, lg
        lengths = lengths + 1
    _cache_out(out, "decode", caches)
    return {k: _np(v) for k, v in out.items()}


def _cache_out(out: dict, tag: str, caches) -> None:
    """Copies of the caches as they stand (the port's are written in place
    by the next call)."""
    for i, c in enumerate(caches):
        for part in ("self", "cross"):
            out[f"{tag}_{part}_k{i}"] = _np(c[part].k).copy()
            out[f"{tag}_{part}_v{i}"] = _np(c[part].v).copy()


def test_reduced_whisper_matches_jax():
    """Seeded non-zero frames through the encoder (non-causal #10's plain
    version), the decoder's learned positions, causal self-attention and
    cross attention; the prefill writes both caches, decode reads the
    cross cache and appends to the self cache."""
    jcfg, tcfg = _configs()
    tree = _params()
    want = _run(jed, jcfg, jax.tree.map(jnp.asarray, tree))
    got = _run(ted, tcfg, ted.params_from_numpy(tcfg, tree, device="cpu"))
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], key)
    assert got["prefill_cross_k0"].shape == (B, FRAMES, 4, 16)
    assert np.abs(got["prefill_cross_k0"]).max() > 0
    np.testing.assert_array_equal(got["prefill_cross_k1"],
                                  got["decode_cross_k1"])


def test_full_config_and_parameter_count():
    fields = ("encoder_layers", "decoder_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "num_frames",
              "act", "norm", "max_position", "num_layers")
    for get in ("get_config", "get_reduced"):
        cfg = getattr(tconfigs, get)(ARCH)
        jcfg = getattr(jconfigs, get)(ARCH)
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (get, f)
        assert ted.count_params(cfg) == jbuild_model(jcfg).count_params
    full = tconfigs.get_config(ARCH)
    assert ted.count_params(full) == 61_687_296
    tcfg = tconfigs.get_reduced(ARCH)
    p = ted.init_params(tcfg, seed=2, device="cpu")
    size = sum(v.numel() for v in jax.tree.leaves(p))
    assert size == ted.count_params(tcfg)
    assert 0.015 < float(p["dec_pos"].std()) < 0.025
    bundle = tbuild_model(tcfg, device="cpu")
    shape_fn, dtype = bundle.extra_inputs["frames"]
    assert shape_fn(3, 9) == (3, FRAMES, D) and dtype == torch.float32
    assert bundle.count_params == size
    with pytest.raises(ValueError, match="encoder layers"):
        ted.params_from_numpy(dataclasses.replace(tcfg, encoder_layers=3),
                              _params(), device="cpu")


# ---------------------------------------------------------------------------
# Serving: the datastore, the engine with the hook, slot isolation
# ---------------------------------------------------------------------------

def _models():
    if "models" not in _ONCE:
        jcfg, tcfg = _configs()
        tree = _params()
        _ONCE["models"] = (jbuild_model(jcfg),
                           jax.tree.map(jnp.asarray, tree),
                           tbuild_model(tcfg, device="cpu"),
                           ted.params_from_numpy(tcfg, tree, device="cpu"))
    return _ONCE["models"]


def test_datastore_and_engine_with_the_hook_match_jax(monkeypatch):
    """``build_datastore``'s keys (zero frames) equal the reference's by
    id, its values too; the engine with the hook over each package's own
    store serves right-padded prompts in two waves with the same greedy
    tokens, and every sampling step's hooked logits agree."""
    jb, jp, tb, tp = _models()
    corpus = np.random.default_rng(4).integers(1, VOCAB, (4, 14))
    jstore = jknnlm.build_datastore(jb, jp, corpus, m=4)
    monkeypatch.setattr(tknnlm, "FORWARD_BATCH", 3)   # two micro-batches
    tstore = tknnlm.build_datastore(tb, tp, corpus, m=4)
    assert tstore.index.n == jstore.index.n == 4 * 13
    np.testing.assert_array_equal(tstore.next_tokens,
                                  np.asarray(jstore.next_tokens))
    order_t = np.argsort(tstore.index.point_ids.numpy())
    order_j = np.argsort(np.asarray(jstore.index.point_ids))
    _close(tstore.index.data.numpy()[order_t],
           np.asarray(jstore.index.data)[order_j], "keys")
    cfg = dict(slots=2, max_seq=32, prefill_len=9)
    rng = np.random.default_rng(3)
    reqs = [(u, rng.integers(1, VOCAB, 5 + u % 5), 4) for u in range(4)]
    outs, hooked = [], []
    for mod, bundle, params, km, store in (
            (tengine, tb, tp, tknnlm, tstore),
            (jengine, jb, jp, jknnlm, jstore)):
        hook = km.KNNLMHook(store=store, k=4, lam=0.3)
        steps = []

        def keep(logits, hidden, hook=hook, steps=steps):
            out = hook(logits, hidden)
            steps.append(_np(out))
            return out

        eng = mod.Engine(bundle, params, mod.EngineConfig(**cfg),
                         logits_hook=keep)
        for uid, prompt, new in reqs:
            eng.submit(mod.Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
        outs.append({r.uid: list(map(int, r.output))
                     for r in eng.run(max_ticks=100)})
        hooked.append(steps)
    assert outs[0] == outs[1]
    assert len(hooked[0]) == len(hooked[1]) == 8
    for i, (g, w) in enumerate(zip(*hooked, strict=True)):
        _close(g, w, f"hooked logits of step {i}")


def test_admission_leaves_a_running_slot_bit_equal():
    """A request admitted while another decodes rewrites only its own
    slot: the running slot's self and cross cache rows are bit-equal
    across the admission, the admitted slot's cross rows are written."""
    _, _, tb, tp = _models()
    eng = tengine.Engine(tb, tp, tengine.EngineConfig(slots=2, max_seq=24,
                                                      prefill_len=6))
    rng = np.random.default_rng(9)
    eng.submit(tengine.Request(uid=0, prompt=rng.integers(1, VOCAB, 6),
                               max_new_tokens=8))
    eng.step()
    eng.step()
    leaves = tengine._cache_leaves(eng.caches)
    assert len(leaves) == 2 * 2 * 2        # layers x {self, cross} x {k, v}
    before = [t[0].clone() for t in leaves]
    cross = [c["cross"] for c in eng.caches]
    assert not any(bool(c.k[1].any()) or bool(c.v[1].any()) for c in cross)
    eng.submit(tengine.Request(uid=1, prompt=rng.integers(1, VOCAB, 4),
                               max_new_tokens=8))
    eng._admit()
    for t, b in zip(tengine._cache_leaves(eng.caches), before, strict=True):
        assert torch.equal(t[0], b)
    cross = [c["cross"] for c in eng.caches]
    assert all(bool(c.k[1].any()) and bool(c.v[1].any()) for c in cross)
