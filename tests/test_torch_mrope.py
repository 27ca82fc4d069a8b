"""The port's M-RoPE, patch stub and learned positions against the JAX
package's on the CPU: ``apply_rope`` with distinct (B, S, 3) positions
(and bit-equal to 1-D RoPE when the three components are equal), reduced
qwen2-vl-72b's forward / prefill / decode with seeded non-zero
``patch_embeds`` and distinct position components, ``pos_embedding=
"learned"`` on a reduced decoder-only config, the full config's parameter
count, the datastore's keys against the reference's ``build_datastore``,
and the engine with the kNN-LM hook against the reference's engine.  The
same numpy inputs, made from a seed, go to both packages; the reference's
parameters reach the port through ``params_from_numpy``.

Tolerance: everything computes in fp32 and is held to 1e-5 of the
reference's max |value| (sums in another order through two layers); the
greedy tokens compare equal.  The JAX side runs under ``jax.jit``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.serve import knnlm as jknnlm

from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.models.registry import model_inputs
from repro_torch.serve import engine as tengine
from repro_torch.serve import knnlm as tknnlm

ARCH = "qwen2-vl-72b"
VOCAB = 512
B, S, S_MAX = 2, 10, 16
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


def _positions3(b: int, s: int) -> np.ndarray:
    """(B, S, 3) positions whose three components differ: temporal, height
    and width of a patch grid three wide, shifted per row."""
    t = np.arange(s)
    grid = np.stack([t, t // 3, t % 3], -1)
    return np.stack([grid + r for r in range(b)]).astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("section,d,theta", [((2, 3, 3), 16, 1e6),
                                             ((16, 24, 24), 128, 1e6),
                                             ((1, 1, 2), 8, 1e4)])
def test_mrope_matches_jax(section, d, theta):
    """Distinct (B, S, 3) components, (B, S) positions broadcast to three
    components, and (B, S, 3) positions under plain RoPE (component 0)."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    pos2 = pos3[..., 1].copy()
    cases = [(pos3, section), (pos2, section), (pos3, None)]
    for pos, sec in cases:
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                  sec)
        got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta, sec)
        _close(got, want, (pos.shape, sec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrope_on_equal_components_is_1d_rope_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 9, 4, 16)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 1 << 15, (2, 9)))
    plain = tlayers.apply_rope(x, pos, 1e6)
    for p in (pos, pos[..., None].expand(2, 9, 3)):
        assert torch.equal(tlayers.apply_rope(x, p, 1e6, (2, 3, 3)), plain)
    distinct = torch.stack([pos, pos + 1, pos + 2], -1)
    assert not torch.equal(tlayers.apply_rope(x, distinct, 1e6, (2, 3, 3)),
                           plain)
    with pytest.raises(ValueError, match="half the head dim"):
        tlayers.apply_rope(x, pos, 1e6, (2, 3, 2))


# ---------------------------------------------------------------------------
# Reduced models: forward, prefill, decode
# ---------------------------------------------------------------------------

def _configs(arch: str = ARCH, **over):
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                compute_dtype=jnp.float32, **over),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                compute_dtype=torch.float32, **over))


def _params(arch: str = ARCH, **over):
    key = ("params", arch, tuple(sorted(over.items())))
    if key not in _ONCE:
        jcfg, _ = _configs(arch, **over)
        init = jax.jit(functools.partial(jtf.init_params, jcfg))
        _ONCE[key] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return _ONCE[key]


def _run(mod, cfg, params, pos, patches):
    """forward_train, then prefill (hidden and caches) and two decode steps
    (logits, hidden, caches), as float32 numpy.  ``pos`` (B, S) or (B, S,
    3); decode positions follow component by component."""
    torch_side = mod is ttf
    arr = torch.from_numpy if torch_side else jnp.asarray
    toks = np.random.default_rng(7).integers(1, VOCAB, (B, S)).astype(
        np.int32)
    fns = [functools.partial(f, cfg) for f in
           (mod.forward_train, mod.prefill, mod.decode_step)]
    if not torch_side:
        fns = [jax.jit(f) for f in fns]
    forward, prefill, decode = fns
    extra = () if patches is None else (arr(patches),)
    out = {"forward": forward(params, arr(toks), arr(pos), *extra)[0]}
    caches = (mod.init_cache(cfg, B, S_MAX, device="cpu") if torch_side
              else mod.init_cache(cfg, B, S_MAX))
    out["prefill"], caches = prefill(params, arr(toks), arr(pos), caches,
                                     arr(np.zeros((B,), np.int32)), *extra)
    lengths = np.full((B,), S, np.int32)
    for step in range(2):
        p = pos[:, -1:] + 1 + step
        lg, hd, caches = decode(params, arr(toks[:, step:step + 1].copy()),
                                arr(p.copy()), caches, arr(lengths))
        out[f"decode_hidden{step}"], out[f"decode_logits{step}"] = hd, lg
        lengths = lengths + 1
    for i, c in enumerate(caches):
        out[f"cache_k{i}"], out[f"cache_v{i}"] = c["mixer"].k, c["mixer"].v
    return {k: _np(v) for k, v in out.items()}


def _compare(arch: str, pos, patches, **over):
    jcfg, tcfg = _configs(arch, **over)
    tree = _params(arch, **over)
    want = _run(jtf, jcfg, jax.tree.map(jnp.asarray, tree), pos, patches)
    got = _run(ttf, tcfg, ttf.params_from_numpy(tcfg, tree, device="cpu"),
               pos, patches)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], key)
    return got


def test_reduced_qwen2_vl_with_patches_matches_jax():
    """Seeded non-zero patch embeddings in place of the first 4 tokens and
    positions whose three components differ, through forward_train,
    prefill (hidden states, both layers' caches) and two decode steps at
    (B, 1, 3) positions."""
    patches = np.random.default_rng(5).normal(size=(B, 4, 64)).astype(
        np.float32)
    got = _compare(ARCH, _positions3(B, S), patches)
    # The patches and the sections matter: other inputs, other states.
    _, tcfg = _configs()
    tp = ttf.params_from_numpy(tcfg, _params(), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, VOCAB, (B, S)))
    pos3 = torch.from_numpy(_positions3(B, S))
    plain, _ = ttf.forward_train(tcfg, tp, toks, pos3[..., 0])
    no_patch, _ = ttf.forward_train(tcfg, tp, toks, pos3)
    assert not np.allclose(plain.numpy(), no_patch.numpy())
    assert not np.allclose(no_patch.numpy(), got["forward"])


def test_patches_longer_than_the_prefill_raise():
    _, tcfg = _configs()
    tp = ttf.params_from_numpy(tcfg, _params(), device="cpu")
    toks = torch.ones((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="4 patch embeddings"):
        ttf.forward_train(tcfg, tp, toks, torch.arange(3)[None],
                          torch.zeros((1, 4, 64)))


def test_learned_positions_match_jax():
    """``pos_embedding="learned"`` on reduced starcoder2-3b: the table's
    rows at component 0 of the positions added to the embeddings, no
    RoPE; the port's own init draws the table at 0.02 and counts it."""
    over = dict(pos_embedding="learned", max_position=64)
    _compare("starcoder2-3b", _positions3(B, S), None, **over)
    _, tcfg = _configs("starcoder2-3b", **over)
    p = ttf.init_params(tcfg, seed=1, device="cpu")
    assert p["pos_embed"].shape == (64, 64)
    assert 0.015 < float(p["pos_embed"].std()) < 0.025
    size = sum(v.size for v in jax.tree.leaves(
        _params("starcoder2-3b", **over)))
    assert ttf.count_params(tcfg) == size


def test_full_config_and_parameter_count():
    fields = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "qkv_bias", "rope_theta",
              "mrope_section", "num_patch_tokens", "max_position",
              "pos_embedding", "tie_embeddings", "scan_layers")
    for get in ("get_config", "get_reduced"):
        cfg = getattr(tconfigs, get)(ARCH)
        jcfg = getattr(jconfigs, get)(ARCH)
        for f in fields:
            assert getattr(cfg, f) == getattr(jcfg, f), (get, f)
    cfg = tconfigs.get_config(ARCH)
    assert ttf.count_params(cfg) == jtf.count_params(
        jconfigs.get_config(ARCH)) == 72_706_203_648
    assert ttf.count_params(tconfigs.get_config(ARCH, num_layers=12)) == \
        13_023_641_600
    bundle = tbuild_model(tconfigs.get_reduced(ARCH), device="cpu")
    shape_fn, dtype = bundle.extra_inputs["patch_embeds"]
    assert shape_fn(3, 9) == (3, 4, 64) and dtype == torch.float32


# ---------------------------------------------------------------------------
# Serving: the datastore and the engine with the hook
# ---------------------------------------------------------------------------

def _models():
    if "models" not in _ONCE:
        jcfg, tcfg = _configs()
        tree = _params()
        _ONCE["models"] = (jbuild_model(jcfg),
                           jax.tree.map(jnp.asarray, tree),
                           tbuild_model(tcfg, device="cpu"),
                           ttf.params_from_numpy(tcfg, tree, device="cpu"))
    return _ONCE["models"]


def test_datastore_and_engine_with_the_hook_match_jax(monkeypatch):
    """``build_datastore``'s keys (M-RoPE positions, zero patch embeddings
    over the first 4 positions of every corpus row) equal the reference's
    by id, its values too; the engine with the hook over each package's
    own store serves right-padded prompts with the same greedy tokens,
    the decode positions three equal components."""
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
    batch = model_inputs(tb, torch.ones((2, 6), dtype=torch.int32),
                         torch.arange(6)[None].expand(2, 6))
    assert batch["positions"].shape == (2, 6, 3)
    assert batch["patch_embeds"].shape == (2, 4, 64)
    seen = []
    inner = tengine.Engine._positions

    def spy(self, pos):
        out = inner(self, pos)
        seen.append(tuple(out.shape))
        return out

    monkeypatch.setattr(tengine.Engine, "_positions", spy)
    cfg = dict(slots=2, max_seq=32, prefill_len=9)
    rng = np.random.default_rng(3)
    reqs = [(u, rng.integers(1, VOCAB, 5 + u % 5), 4) for u in range(4)]
    hooks = (tknnlm.KNNLMHook(store=tstore, k=4, lam=0.3),
             jknnlm.KNNLMHook(store=jstore, k=4, lam=0.3))
    outs = []
    for mod, bundle, params, hook in ((tengine, tb, tp, hooks[0]),
                                      (jengine, jb, jp, hooks[1])):
        eng = mod.Engine(bundle, params, mod.EngineConfig(**cfg),
                         logits_hook=hook)
        for uid, prompt, new in reqs:
            eng.submit(mod.Request(uid=uid, prompt=prompt,
                                   max_new_tokens=new))
        outs.append({r.uid: list(map(int, r.output))
                     for r in eng.run(max_ticks=100)})
    assert outs[0] == outs[1]
    assert hooks[0].queries_served == hooks[1].queries_served == sum(
        r[2] for r in reqs)
    assert seen and all(s == (2, 1, 3) for s in seen)
