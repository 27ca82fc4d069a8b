"""The port's serving engine and kNN-LM hook against the JAX package's on the
CPU (reduced starcoder2-3b, the reference's parameters carried across as
numpy arrays).

Both sides run in the fp32 compute dtype: greedy tokens are compared for
equality, and in bf16 the two frameworks round at different places
(tests/test_torch_models.py), which can flip an argmax between two close
logits; in fp32 their logits agree to ~1e-5, far inside any gap a greedy
choice meets here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import search as jsearch
from repro.models.registry import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.serve import knnlm as jknnlm

from repro_torch import configs as tconfigs
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import knnlm as tknnlm

from torch_parity import to_port

VOCAB = 512


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jconfigs.get_reduced("starcoder2-3b"),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_reduced("starcoder2-3b"),
                               compute_dtype=torch.float32)
    jbundle = jbuild_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tbundle = tbuild_model(tcfg, device="cpu")
    tparams = ttf.params_from_numpy(tcfg, tree, device="cpu")
    return jbundle, jparams, tbundle, tparams


def _prompt(uid, length, seed=0):
    return np.random.default_rng(seed + uid).integers(1, VOCAB, length)


def _serve(mod, bundle, params, cfg, reqs, hook=None):
    """Run one engine over (uid, prompt, max_new_tokens) triples; returns
    {uid: output}."""
    eng = mod.Engine(bundle, params, cfg, logits_hook=hook)
    for uid, prompt, new in reqs:
        eng.submit(mod.Request(uid=uid, prompt=prompt, max_new_tokens=new))
    done = eng.run(max_ticks=200)
    return {r.uid: list(map(int, r.output)) for r in done}, eng


def test_engine_matches_jax(models):
    """More requests than slots, prompts of different lengths (right
    padding), different budgets: the same greedy tokens."""
    jb, jp, tb, tp = models
    cfg = dict(slots=3, max_seq=40, prefill_len=12)
    reqs = [(u, _prompt(u, 5 + 2 * (u % 4)), 3 + u % 3) for u in range(7)]
    got, eng = _serve(tengine, tb, tp, tengine.EngineConfig(**cfg), reqs)
    want, jeng = _serve(jengine, jb, jp, jengine.EngineConfig(**cfg), reqs)
    assert got == want
    assert eng.ticks == jeng.ticks
    assert all(len(got[u]) == new for u, _, new in reqs)


def test_slot_isolation_matches_jax(models):
    """Admitting requests mid-flight leaves a running request's tokens as
    they are alone; the crowded run equals the reference's."""
    jb, jp, tb, tp = models
    prompt = (np.arange(1, 13) * 7) % VOCAB
    outs = {}
    for name, mod, bundle, params in (("port", tengine, tb, tp),
                                      ("jax", jengine, jb, jp)):
        cfg = mod.EngineConfig(slots=2, max_seq=64, prefill_len=12)
        alone, _ = _serve(mod, bundle, params, cfg, [(0, prompt, 8)])
        eng = mod.Engine(bundle, params, cfg)
        eng.submit(mod.Request(uid=0, prompt=prompt, max_new_tokens=8))
        eng.step()
        eng.submit(mod.Request(uid=1, prompt=_prompt(1, 12, 5),
                               max_new_tokens=6))
        eng.step()
        eng.submit(mod.Request(uid=2, prompt=_prompt(2, 12, 9),
                               max_new_tokens=6))
        eng.run(max_ticks=50)
        crowded = {r.uid: list(map(int, r.output)) for r in eng.finished}
        assert crowded[0] == alone[0], name
        outs[name] = crowded
    assert outs["port"] == outs["jax"]


def test_termination_matches_jax(models):
    """max_new_tokens=1 emits one token and takes no decode tick; an EOS
    sampled at admission or in decode ends the request there."""
    jb, jp, tb, tp = models
    cfg = dict(slots=2, max_seq=32, prefill_len=8)
    one = [(0, _prompt(0, 8), 1), (1, _prompt(1, 6), 1)]
    got, eng = _serve(tengine, tb, tp, tengine.EngineConfig(**cfg), one)
    want, _ = _serve(jengine, jb, jp, jengine.EngineConfig(**cfg), one)
    assert got == want and all(len(o) == 1 for o in got.values())
    assert eng.ticks == 0
    free, _ = _serve(tengine, tb, tp, tengine.EngineConfig(**cfg),
                     [(0, _prompt(3, 8), 6)])
    eos = free[0][2]                      # the third token it would emit
    first = free[0].index(eos)
    reqs = [(0, _prompt(3, 8), 6), (1, _prompt(4, 7), 6)]
    got, _ = _serve(tengine, tb, tp,
                    tengine.EngineConfig(eos_token=eos, **cfg), reqs)
    want, _ = _serve(jengine, jb, jp,
                     jengine.EngineConfig(eos_token=eos, **cfg), reqs)
    assert got == want
    assert got[0] == free[0][:first + 1]


@pytest.fixture(scope="module")
def jax_store(models):
    jb, jp, _, _ = models
    corpus = np.random.default_rng(0).integers(1, VOCAB, (4, 24))
    return jknnlm.build_datastore(jb, jp, corpus, m=4), corpus


def test_hook_on_the_jax_forest_matches_jax(models, jax_store):
    """The reference's datastore imported (forest_from_numpy, its
    next_tokens): the mixed log-probs agree and the neighbour ids are the
    reference's."""
    store, _ = jax_store
    port_store = tknnlm.Datastore(
        index=to_port(store.index), next_tokens=np.asarray(store.next_tokens),
        hidden_dim=store.hidden_dim, block_rows=4096)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, VOCAB)).astype(np.float32) * 3
    hidden = rng.normal(size=(3, 64)).astype(np.float32)
    jhook = jknnlm.KNNLMHook(store=store, k=4, lam=0.5)
    thook = tknnlm.KNNLMHook(store=port_store, k=4, lam=0.5)
    want = np.asarray(jhook(jnp.asarray(logits), jnp.asarray(hidden)))
    got = thook(torch.from_numpy(logits), torch.from_numpy(hidden)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    res = jsearch.knn_batch(store.index, jnp.asarray(hidden), 4)
    np.testing.assert_array_equal(thook.last_result.ids.numpy(),
                                  np.asarray(res.ids))
    assert thook.queries_served == jhook.queries_served == 3
    assert thook.budget_final == jhook.budget_final
    assert (thook.escalations, thook.scan_fallbacks) == (
        jhook.escalations, jhook.scan_fallbacks)


def test_port_datastore_matches_jax_and_serves_the_same_tokens(models,
                                                              jax_store,
                                                              monkeypatch):
    """build_datastore's keys equal the reference's (by original id), its
    values too; the engine with the hook over each package's own store
    gives the same greedy tokens."""
    jb, jp, tb, tp = models
    store, corpus = jax_store
    monkeypatch.setattr(tknnlm, "FORWARD_BATCH", 3)   # two micro-batches
    port_store = tknnlm.build_datastore(tb, tp, corpus, m=4)
    assert port_store.index.n == store.index.n == 4 * 23
    assert port_store.block_rows == 4096
    np.testing.assert_array_equal(port_store.next_tokens,
                                  np.asarray(store.next_tokens))
    order_t = np.argsort(port_store.index.point_ids.numpy())
    order_j = np.argsort(np.asarray(store.index.point_ids))
    np.testing.assert_allclose(
        port_store.index.data.numpy()[order_t],
        np.asarray(store.index.data)[order_j], rtol=1e-5, atol=1e-5)
    cfg = dict(slots=2, max_seq=48, prefill_len=12)
    reqs = [(u, _prompt(u, 12), 4) for u in range(3)]
    thook = tknnlm.KNNLMHook(store=port_store, k=4, lam=0.3)
    jhook = jknnlm.KNNLMHook(store=store, k=4, lam=0.3)
    got, _ = _serve(tengine, tb, tp, tengine.EngineConfig(**cfg), reqs,
                    hook=thook)
    want, _ = _serve(jengine, jb, jp, jengine.EngineConfig(**cfg), reqs,
                     hook=jhook)
    assert got == want
    assert thook.queries_served == jhook.queries_served >= 12


def test_int8_and_tiered_datastores_serve_the_resident_fp32_ids(models):
    """``quantize=True`` keys the store in the int8 tier (exact over its
    decoded keys); ``resident_bytes`` routes lookups through a
    TieredPointStore, whose ids equal the resident store's."""
    _, _, tb, tp = models
    corpus = np.random.default_rng(2).integers(1, VOCAB, (4, 24))
    hidden = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 64)).astype(np.float32))
    logits = torch.zeros((3, VOCAB))
    resident = tknnlm.build_datastore(tb, tp, corpus, m=4)
    tiered = tknnlm.build_datastore(tb, tp, corpus, m=4, resident_bytes=64)
    int8 = tknnlm.build_datastore(tb, tp, corpus, m=4, quantize=True)
    assert tiered.search_index() is tiered.search_index()
    assert not tiered.search_index().is_resident
    ids = {}
    for name, store in (("resident", resident), ("tiered", tiered),
                        ("int8", int8)):
        hook = tknnlm.KNNLMHook(store=store, k=4)
        hook(logits, hidden)
        ids[name] = hook.last_result.ids
    assert torch.equal(ids["tiered"], ids["resident"])
    rows = int8.index.rows_view()[torch.argsort(int8.index.point_ids.long())]
    want = torch.argsort(((hidden[:, None] - rows[None]) ** 2).sum(-1),
                         dim=1, stable=True)[:, :4]
    assert torch.equal(ids["int8"].long(), want)
    assert int8.index.storage == "int8"


def test_what_is_not_ported_raises(models):
    _, _, tb, tp = models
    corpus = np.random.default_rng(0).integers(1, VOCAB, (2, 16))
    store = tknnlm.build_datastore(tb, tp, corpus, m=2)
    # grow / evict are ported (tests/test_torch_segments.py and
    # test_datastore_grow_evict_contract below); the approximate hook is not.
    assert store.grow(np.zeros((1, 64), np.float32),
                      np.zeros(1, np.int32)).tolist() == [store.index.n - 1]
    assert store.evict([0]) == 1
    with pytest.raises(TypeError):
        tknnlm.KNNLMHook(store=store, approx_p=0.9)
    with pytest.raises(NotImplementedError, match="item 12"):
        tbuild_model(type("EncDecConfig", (), {})(), device="cpu")


def test_hook_mixture_with_repeated_tokens_matches_jax(models):
    """k = 8 neighbours whose next tokens repeat (three or more share one):
    the port adds the weights a neighbour column at a time, as the
    reference's serial scatter does; the mixed log-probs agree and the
    mixture equals a float64 sum of the same weights."""
    from repro.core.index import build_index as jax_build_index
    rng = np.random.default_rng(4)
    keys = rng.normal(size=(200, 16)).astype(np.float32)
    toks = (np.arange(200) % 3).astype(np.int32)
    jf = jax_build_index(keys, "squared_euclidean", m=4, num_clusters=8,
                         seed=0)
    jstore = jknnlm.Datastore(index=jf, next_tokens=toks, hidden_dim=16)
    tstore = tknnlm.Datastore(index=to_port(jf), next_tokens=toks,
                              hidden_dim=16)
    logits = rng.normal(size=(4, 8)).astype(np.float32)
    hidden = keys[:4] + np.float32(0.05)
    jhook = jknnlm.KNNLMHook(store=jstore, k=8, lam=0.5, temperature=4.0)
    thook = tknnlm.KNNLMHook(store=tstore, k=8, lam=0.5, temperature=4.0)
    want = np.asarray(jhook(jnp.asarray(logits), jnp.asarray(hidden)))
    got = thook(torch.from_numpy(logits), torch.from_numpy(hidden)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    knn_toks = toks[thook.last_result.ids.numpy()]
    assert all(np.bincount(row).max() >= 3 for row in knn_toks)
    w = torch.softmax(-thook.last_result.dists / 4.0, dim=-1)
    p = tknnlm.knn_distribution(torch.from_numpy(knn_toks).long(), w, 8)
    want64 = np.zeros((4, 8))
    for r in range(4):
        np.add.at(want64[r], knn_toks[r], w[r].double().numpy())
    np.testing.assert_allclose(p.double().numpy(), want64, rtol=1e-6,
                               atol=1e-7)
    # Column by column equals the CPU's serial scatter over all k columns.
    assert torch.equal(p, torch.zeros((4, 8)).scatter_add_(
        1, torch.from_numpy(knn_toks).long(), w))


def test_datastore_grow_evict_contract():
    """tests/test_segments.py's Datastore contract on the port: grown keys
    are found by the next hook call and lead the mix, evicted ones never
    surface, bad shapes raise, and fewer than k live keys leave the
    logits as they are."""
    from repro_torch.core import index as tidx
    from repro_torch.core.segments import SegmentedForest
    rng = np.random.default_rng(8)
    data = rng.normal(size=(220, 16)).astype(np.float32)
    store = tknnlm.Datastore(
        index=tidx.build_index(data[:200], "squared_euclidean", m=4,
                               num_clusters=8, seed=0, device="cpu"),
        next_tokens=np.arange(200, dtype=np.int32) % 32, hidden_dim=16)
    hook = tknnlm.KNNLMHook(store=store, k=4, lam=0.5)
    logits = torch.zeros((3, 32))
    hook(logits, torch.from_numpy(data[:3]))
    new_ids = store.grow(data[200:220], np.full(20, 7, np.int32))
    assert isinstance(store.index, SegmentedForest)
    assert store.next_tokens.shape == (220,) and store.version == 1
    res = _knn(store.index, data[200:203], 1)
    np.testing.assert_array_equal(res.ids.numpy().ravel(), new_ids[:3])
    out = hook(logits, torch.from_numpy(data[200:203]))
    assert out.shape == (3, 32) and int(torch.argmax(out[0])) == 7
    assert hook._next_dev.shape == (220,)
    assert store.evict(new_ids) == 20 and store.version == 2
    res2 = _knn(store.index, data[200:203], 1)
    assert not np.isin(res2.ids.numpy(), new_ids).any()
    with pytest.raises(ValueError, match="one next-token per key"):
        store.grow(data[:2], np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="expected"):
        store.grow(np.ones((2, 18), np.float32), np.zeros(2, np.int32))
    store.auto_compact = False
    store.evict(np.arange(200 - hook.k + 1))
    assert store.index.live_n < hook.k and store.index.n == 220
    assert torch.equal(hook(logits, torch.from_numpy(data[:3])), logits)


def test_tiered_datastore_snapshot_follows_the_version():
    """With ``resident_bytes`` the store's tiered snapshot is made again
    (the old one closed) when a mutation moves the version."""
    from repro_torch.core import index as tidx
    rng = np.random.default_rng(9)
    data = rng.normal(size=(300, 16)).astype(np.float32)
    store = tknnlm.Datastore(
        index=tidx.build_index(data[:260], "squared_euclidean", m=4,
                               num_clusters=8, seed=0, device="cpu"),
        next_tokens=np.zeros(260, np.int32), hidden_dim=16,
        block_rows=64, resident_bytes=4096)
    first = store.search_index()
    assert store.search_index() is first and not first.is_resident
    ids = store.grow(data[260:], np.ones(40, np.int32))
    second = store.search_index()
    assert second is not first and first._executor is None
    assert second._pinned
    res = _knn(second, data[260:263], 1)
    np.testing.assert_array_equal(res.ids.numpy().ravel(), ids[:3])


def _knn(index, ys, k):
    from repro_torch.core import search as tsearch
    return tsearch.knn_batch(index, ys, k, device="cpu")
