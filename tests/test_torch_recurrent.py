"""The port's recurrent families against the JAX package's on the CPU: the
RG-LRU block (conv1d, the scan with and without a carried state, the
decode step), the RWKV-6 pieces (the chunked WKV with a ragged last chunk,
its decode step, both mixes), reduced recurrentgemma-2b and rwkv6-1.6b
(``forward_train`` / ``prefill`` / ``decode_step``, rwkv6 also imported
from a stacked ``scan_layers`` tree), the full configs' parameter counts,
and the serving engine's recurrent path with the kNN-LM hook.  The same
numpy inputs, made from a seed, go to both packages.

Tolerances:

* fp32: rtol/atol 1e-4 (tests/test_scan_serving.py's; the port's scan
  combines in another order than ``jax.lax.associative_scan``, and sums
  run in another order through a few layers).
* bf16: twice the reference's own bf16 error against its fp32 result plus
  one bf16 ulp at the tensor's scale (tests/test_torch_models.py's rule:
  XLA and PyTorch round bf16 intermediates at different places).
* Greedy tokens run in fp32 compute and compare equal.

The JAX side runs under ``jax.jit`` (one compile a function and shape, where
op-by-op dispatch of the scans would take minutes of the tier-1 budget).

The engine tests use fresh slots wherever they compare with the reference:
on a reused slot the reference starts from the previous request's state
(ROADMAP §3), the port from zeros, as a fresh engine does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import search as jsearch
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild_model
from repro.serve import engine as jengine
from repro.serve import knnlm as jknnlm

from repro_torch import configs as tconfigs
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import knnlm as tknnlm

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_FP32 = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")
VOCAB = 512


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_bf16(got, want, truth, key=""):
    """|port bf16 - jax bf16| within twice the reference's bf16 error
    against its fp32 result, plus one bf16 ulp at the tensor's scale."""
    g, w, t = _np(got), _np(want), _np(truth)
    assert g.shape == w.shape, key
    bound = 2.0 * float(np.abs(w - t).max()) + 2.0 ** -8 * float(
        np.abs(t).max())
    assert float(np.abs(g - w).max()) <= bound, (key, bound)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


_ONCE: dict = {}


def _once(key, fn):
    """``fn()``'s result, computed once a test run: the reference's fp32
    results serve both dtypes' tests (each jit compiles anew)."""
    if key not in _ONCE:
        _ONCE[key] = fn()
    return _ONCE[key]


def _jax_params(spec_fn, *args, seed=0):
    """The reference's init of a block's specs, as a numpy tree."""
    from repro.models.layers import init_tree
    return jax.tree.map(np.array,
                        init_tree(jax.random.PRNGKey(seed), spec_fn(*args)))


# ---------------------------------------------------------------------------
# RG-LRU pieces
# ---------------------------------------------------------------------------

B, S, W, D = 2, 11, 16, 12


def test_conv1d_and_scan_match_jax():
    x = _normal((B, S, W), 0)
    w, bias = _normal((4, W), 1, 0.3), _normal((W,), 2)
    st = _normal((B, 3, W), 3)
    for state in (None, st):
        yj, sj = jrglru.conv1d_causal(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
            None if state is None else jnp.asarray(state))
        yt, stt = trglru.conv1d_causal(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(_np(stt), _np(sj))
    r = 1 / (1 + np.exp(-_normal((B, S, W), 4)))
    i = 1 / (1 + np.exp(-_normal((B, S, W), 5)))
    lam = np.array(jrglru._lambda_init(jnp.asarray(_normal((W,), 6))))
    np.testing.assert_allclose(
        _np(trglru._lambda_init(torch.from_numpy(_normal((W,), 6)))), lam,
        rtol=1e-5, atol=1e-6)
    h0 = _normal((B, W), 7)
    for length in (1, 2, S, 64):     # a single step, a power of two
        xs = _normal((B, length, W), 8)
        rs, is_ = (np.resize(t, (B, length, W)).astype(np.float32)
                   for t in (r, i))
        for carried in (None, h0):
            hj, lj = jax.jit(jrglru.rglru_scan)(
                *map(jnp.asarray, (xs, rs, is_, lam)),
                None if carried is None else jnp.asarray(carried))
            ht, lt = trglru.rglru_scan(
                *map(torch.from_numpy, (xs, rs, is_, lam)),
                None if carried is None else torch.from_numpy(carried))
            assert ht.dtype == torch.float32 and ht.shape == (B, length, W)
            np.testing.assert_allclose(_np(ht), _np(hj), **TOL_FP32)
            np.testing.assert_allclose(_np(lt), _np(lj), **TOL_FP32)
    # One decode step continues the scan: h_S from h_{S-1}.
    hj, _ = jax.jit(jrglru.rglru_step)(*map(jnp.asarray, (x[:, 0], r[:, 0], i[:, 0],
                                                 lam, h0)))
    ht, _ = trglru.rglru_step(*map(torch.from_numpy, (x[:, 0], r[:, 0],
                                                      i[:, 0], lam, h0)))
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rglru_block_matches_jax(dtype):
    """Prefill from a carried state, then two decode steps (the S = 1 fast
    path), and the training form (no state)."""
    tree = _jax_params(jrglru.rglru_spec, D, W)
    jdt, tdt = DTYPES[dtype]
    x = _normal((B, S, D), 9)
    state = {"h": _normal((B, W), 10), "conv": _normal((B, 3, W), 11)}

    def run(jax_side, dt):
        if jax_side:
            p = jax.tree.map(jnp.asarray, tree)
            arr = lambda a: jnp.asarray(a, dt)             # noqa: E731
            fn, st = jax.jit(jrglru.apply_rglru_block), {
                "h": jnp.asarray(state["h"]), "conv": arr(state["conv"])}
        else:
            p = _tree(tree, torch.from_numpy)
            arr = lambda a: torch.from_numpy(a).to(dt)     # noqa: E731
            fn, st = trglru.apply_rglru_block, {
                "h": torch.from_numpy(state["h"]),
                "conv": arr(state["conv"])}
        out = {"train": fn(p, arr(x))[0]}
        out["prefill"], st = fn(p, arr(x), st)
        for step in range(2):
            out[f"decode{step}"], st = fn(p, arr(x[:, step:step + 1]), st)
        out["h"], out["conv"] = st["h"], st["conv"]
        return out

    got = run(False, tdt)
    want = _once(("rglru_block", dtype), lambda: run(True, jdt))
    assert got["h"].dtype == torch.float32 and got["conv"].dtype == tdt
    truth = (_once(("rglru_block", "fp32"), lambda: run(True, jnp.float32))
             if dtype == "bf16" else None)
    for key in want:
        if dtype == "fp32":
            np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                       err_msg=key, **TOL_FP32)
        else:
            _close_bf16(got[key], want[key], truth[key], key)


# ---------------------------------------------------------------------------
# RWKV-6 pieces
# ---------------------------------------------------------------------------

H, N = 3, 4


def test_wkv_chunked_and_step_match_jax():
    """S = 11 over chunks of 4 (a ragged last chunk of 3), strong and weak
    decays, from a carried state; then one decode step."""
    r, k, v = (_normal((B, S, H, N), s) for s in (20, 21, 22))
    logw = -np.exp(np.clip(_normal((B, S, H, N), 23, 3.0), -12, 6)).astype(
        np.float32)
    u, st = _normal((H, N), 24), _normal((B, H, N, N), 25)
    args_j = [jnp.asarray(a) for a in (r, k, v, logw, u, st)]
    args_t = [torch.from_numpy(a) for a in (r, k, v, logw, u, st)]
    for chunk in (4, S, 128):
        oj, sj = jax.jit(functools.partial(jrwkv.wkv_chunked, chunk=chunk))(
            *args_j)
        ot, stt = trwkv.wkv_chunked(*args_t, chunk=chunk)
        np.testing.assert_allclose(_np(ot), _np(oj), **TOL_FP32)
        np.testing.assert_allclose(_np(stt), _np(sj), **TOL_FP32)
    oj, sj = jax.jit(jrwkv.wkv_step)(*(a[:, 0] for a in args_j[:4]), *args_j[4:])
    ot, stt = trwkv.wkv_step(*(a[:, 0] for a in args_t[:4]), *args_t[4:])
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(stt), _np(sj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rwkv_mixes_match_jax(dtype):
    """Time mix (chunk 4 over S = 11) and channel mix: training, prefill
    from a carried state, two decode steps.  The zero-initialised mixing
    and bonus parameters are drawn here, so every term is exercised."""
    d = H * N * 2                                # 24 channels, head dim 8
    hd = 8
    time_p = _jax_params(jrwkv.rwkv_time_spec, d, hd, 4, 8)
    for i, name in enumerate(("mu_first", "mu", "decay_w0", "bonus_u",
                              "ln_bias")):
        time_p[name] = _normal(time_p[name].shape, 30 + i, 0.5)
    chan_p = _jax_params(jrwkv.rwkv_channel_spec, d, 40, seed=1)
    chan_p["mu_k"], chan_p["mu_r"] = _normal((d,), 40), _normal((d,), 41)
    jdt, tdt = DTYPES[dtype]
    x = _normal((B, S, d), 42)
    shift, wkv = _normal((B, d), 43), _normal((B, d // hd, hd, hd), 44, 0.1)

    def run(jax_side, dt):
        if jax_side:
            tp, cp = (jax.tree.map(jnp.asarray, t) for t in (time_p, chan_p))
            arr = lambda a: jnp.asarray(a, dt)             # noqa: E731
            f32 = jnp.asarray
            time_fn = jax.jit(functools.partial(jrwkv.apply_rwkv_time,
                                                head_dim=hd, chunk=4))
            chan_fn = jax.jit(jrwkv.apply_rwkv_channel)
        else:
            tp, cp = (_tree(t, torch.from_numpy) for t in (time_p, chan_p))
            arr = lambda a: torch.from_numpy(a).to(dt)     # noqa: E731
            f32 = torch.from_numpy
            time_fn = functools.partial(trwkv.apply_rwkv_time, head_dim=hd,
                                        chunk=4)
            chan_fn = trwkv.apply_rwkv_channel
        out = {"time_train": time_fn(tp, arr(x))[0],
               "chan_train": chan_fn(cp, arr(x))[0]}
        ts = {"shift": arr(shift), "wkv": f32(wkv)}
        cs = {"shift": arr(shift)}
        for step, (a, b) in enumerate(((0, S), (0, 1), (1, 2))):
            out[f"time{step}"], ts = time_fn(tp, arr(x[:, a:b]), state=ts)
            out[f"chan{step}"], cs = chan_fn(cp, arr(x[:, a:b]), cs)
        out.update(wkv=ts["wkv"], shift=ts["shift"], cshift=cs["shift"])
        return out

    got = run(False, tdt)
    want = _once(("rwkv_mixes", dtype), lambda: run(True, jdt))
    assert got["wkv"].dtype == torch.float32
    truth = (_once(("rwkv_mixes", "fp32"), lambda: run(True, jnp.float32))
             if dtype == "bf16" else None)
    for key in want:
        if dtype == "fp32":
            np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                       err_msg=key, **TOL_FP32)
        else:
            _close_bf16(got[key], want[key], truth[key], key)


# ---------------------------------------------------------------------------
# Reduced models: forward, prefill, decode
# ---------------------------------------------------------------------------

MB, MS, M_MAX = 2, 10, 16
_PARAMS: dict = {}


def _configs(arch: str, dtype: str, **over):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                compute_dtype=jdt, **over),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                compute_dtype=tdt, **over))


def _params(arch: str):
    """The reference's fp32 parameters of the reduced config (numpy)."""
    if arch not in _PARAMS:
        jcfg, _ = _configs(arch, "fp32")
        init = jax.jit(functools.partial(jtf.init_params, jcfg))
        _PARAMS[arch] = jax.tree.map(np.asarray,
                                     init(jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def _leaves(caches) -> list:
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in _leaves(caches[k])]
    if isinstance(caches, (list, tuple)):
        return [t for c in caches for t in _leaves(c)]
    return [] if caches is None else [caches]


def _run(mod, cfg, params):
    """forward_train, prefill (hidden and every cache leaf) and three
    decode steps (hidden, logits, every cache leaf), as float32 numpy."""
    torch_side = mod is ttf
    arr = torch.from_numpy if torch_side else jnp.asarray
    rng = np.random.default_rng(7)
    toks = rng.integers(1, VOCAB, (MB, MS)).astype(np.int32)
    pos = np.broadcast_to(np.arange(MS, dtype=np.int32), (MB, MS)).copy()
    fns = [functools.partial(f, cfg) for f in
           (mod.forward_train, mod.prefill, mod.decode_step)]
    if not torch_side:
        fns = [jax.jit(f) for f in fns]
    forward, prefill, decode = fns
    out = {"forward": forward(params, arr(toks), arr(pos))[0]}
    caches = (mod.init_cache(cfg, MB, M_MAX, device="cpu") if torch_side
              else mod.init_cache(cfg, MB, M_MAX))
    out["prefill"], caches = prefill(params, arr(toks), arr(pos), caches,
                                     arr(np.zeros((MB,), np.int32)))
    lengths = np.full((MB,), MS, np.int32)
    for step in range(3):
        lg, hd, caches = decode(
            params, arr(toks[:, step:step + 1].copy()),
            arr(lengths[:, None].copy()), caches, arr(lengths))
        out[f"decode_hidden{step}"], out[f"decode_logits{step}"] = hd, lg
        lengths = lengths + 1
    for j, leaf in enumerate(_leaves(caches)):
        out[f"cache{j}"] = leaf
    return {k: _np(v) for k, v in out.items()}


def _jax_run(arch: str, dtype: str, tree, **over) -> dict:
    """The reference's ``_run`` of a config, computed once a test run."""
    return _once((arch, dtype, tuple(sorted(over))),
                 lambda: _run(jtf, _configs(arch, dtype, **over)[0],
                              jax.tree.map(jnp.asarray, tree)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_recurrent_models_match_jax(arch, dtype):
    _, tcfg = _configs(arch, dtype)
    tree = _params(arch)
    params = ttf.params_from_numpy(tcfg, tree, device="cpu")
    got = _run(ttf, tcfg, params)
    want = _jax_run(arch, dtype, tree)
    assert got.keys() == want.keys()
    truth = _jax_run(arch, "fp32", tree) if dtype == "bf16" else None
    for key in want:
        assert got[key].shape == want[key].shape, key
        if dtype == "fp32":
            np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                       err_msg=key, **TOL_FP32)
        else:
            _close_bf16(got[key], want[key], truth[key], key)


def test_rwkv6_scan_layers_imports_the_stacked_tree():
    """rwkv6-1.6b as published runs ``scan_layers=True``: the reference
    stacks its parameters (L, ...) and scans prefill and decode over
    stacked caches.  The port imports the stacked tree (each layer a view
    of it) and matches."""
    _, tcfg = _configs("rwkv6-1.6b", "fp32", scan_layers=True)
    tree = dict(_params("rwkv6-1.6b"))
    tree["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *tree["layers"])
    params = ttf.params_from_numpy(tcfg, tree, device="cpu")
    base = params["layers"][0]["mixer"]["lora_b"]._base
    assert base is not None
    assert params["layers"][1]["mixer"]["lora_b"]._base is base
    got = _run(ttf, tcfg, params)
    want = _jax_run("rwkv6-1.6b", "fp32", tree, scan_layers=True)
    for key in ("forward", "prefill", "decode_hidden2", "decode_logits2"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   err_msg=key, **TOL_FP32)


def test_full_configs_and_parameter_counts():
    for arch in ARCHS:
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "block_pattern",
                  "ffn_kind", "act", "norm", "window", "lru_width",
                  "conv_width", "rwkv_head_dim", "rwkv_chunk",
                  "pos_embedding", "rope_theta", "tie_embeddings",
                  "scan_layers"):
            assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
        assert cfg.compute_dtype == torch.bfloat16
        assert ttf.count_params(cfg) == jtf.count_params(jcfg)
    assert ttf.count_params(tconfigs.get_config("recurrentgemma-2b")) \
        == 2_894_574_080
    assert ttf.count_params(tconfigs.get_config("rwkv6-1.6b")) \
        == 1_465_651_200


@pytest.mark.parametrize("arch", ARCHS)
def test_state_zeros_and_flop_count_match_jax(arch):
    """The recurrent state constructors give the reference's shapes and
    dtypes (zeros), and the RG-LRU block's FLOPs a token equal the
    reference's, at the full and the reduced config."""
    import jax.tree_util as jtu
    for cfg in (tconfigs.get_config(arch), tconfigs.get_reduced(arch)):
        for name, dt in DTYPES.items():
            if arch == "rwkv6-1.6b":
                got = trwkv.rwkv_state_zeros(2, cfg.d_model,
                                             cfg.rwkv_head_dim, dt[1],
                                             device="cpu")
                want = jrwkv.rwkv_state_zeros(2, cfg.d_model,
                                              cfg.rwkv_head_dim, dt[0])
            else:
                got = trglru.rglru_state_zeros(2, cfg.lru_width,
                                               cfg.conv_width, dt[1],
                                               device="cpu")
                want = jrglru.rglru_state_zeros(2, cfg.lru_width,
                                                cfg.conv_width, dt[0])
                assert trglru.rglru_flops_per_token(
                    cfg.d_model, cfg.lru_width, cfg.conv_width) \
                    == jrglru.rglru_flops_per_token(
                        cfg.d_model, cfg.lru_width, cfg.conv_width)
            got_leaves = jtu.tree_leaves(got)
            want_leaves = jtu.tree_leaves(want)
            assert jtu.tree_structure(jtu.tree_map(lambda _: 0, got)) \
                == jtu.tree_structure(jtu.tree_map(lambda _: 0, want))
            for g, w in zip(got_leaves, want_leaves, strict=True):
                assert tuple(g.shape) == w.shape, (arch, name)
                assert str(g.dtype)[6:] == str(w.dtype), (arch, name)
                assert not bool(g.any())


def test_recurrent_init_follows_the_spec_rule():
    """The port's own init of the recurrent blocks: fan-in scaling,
    ``scale=0.3`` (the conv), ``scale=None`` on the W x W gates (fan-in),
    RWKV's 0.01 LoRAs, zeros and ones where the specs put them, and
    ``uniform_lambda`` drawn as the reference's materialize draws it (a
    fan-in normal); the tree's size is ``count_params``."""
    for arch in ARCHS:
        cfg = tconfigs.get_reduced(arch)
        p = ttf.init_params(cfg, seed=5, device="cpu")
        again = ttf.init_params(cfg, seed=5, device="cpu")
        name = "w_in" if arch == "recurrentgemma-2b" else "w_r"
        assert torch.equal(p["layers"][0]["mixer"][name],
                           again["layers"][0]["mixer"][name])
        total = p["embed"].numel() + sum(
            t.numel() for t in p["final_norm"].values()) + sum(
            t.numel() for lp in p["layers"] for sub in lp.values()
            for t in sub.values())
        assert total == ttf.count_params(cfg)
    cfg = dataclasses.replace(tconfigs.get_reduced("recurrentgemma-2b"),
                              lru_width=256, d_model=128)
    mx = ttf.init_params(cfg, seed=5, device="cpu")["layers"][0]["mixer"]
    assert abs(float(mx["conv_w"].std()) - 0.3) < 0.03
    assert abs(float(mx["w_a"].std()) - 256 ** -0.5) < 0.005
    assert abs(float(mx["w_in"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(mx["lam"].std()) - 256 ** -0.5) < 0.02
    assert not torch.equal(mx["lam"], torch.zeros(256))
    for name in ("conv_b", "b_a", "b_x"):
        assert torch.equal(mx[name], torch.zeros(256))
    cfg = dataclasses.replace(tconfigs.get_reduced("rwkv6-1.6b"),
                              d_model=256, rwkv_head_dim=64)
    lp = ttf.init_params(cfg, seed=5, device="cpu")["layers"][0]
    assert abs(float(lp["mixer"]["lora_a"].std()) - 0.01) < 0.001
    assert abs(float(lp["mixer"]["w_k"].std()) - 256 ** -0.5) < 0.003
    assert torch.equal(lp["mixer"]["ln_scale"], torch.ones(256))
    assert torch.equal(lp["ffn"]["mu_k"], torch.zeros(256))
    assert lp["ffn"]["w_v"].shape == (128, 256)


# ---------------------------------------------------------------------------
# The engine's recurrent path and the hook
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _models(arch: str):
    """fp32 bundles of both packages over the reference's parameters."""
    if arch not in _MODELS:
        jcfg, tcfg = _configs(arch, "fp32")
        tree = _params(arch)
        _MODELS[arch] = (jbuild_model(jcfg), jax.tree.map(jnp.asarray, tree),
                         tbuild_model(tcfg, device="cpu"),
                         ttf.params_from_numpy(tcfg, tree, device="cpu"))
    return _MODELS[arch]


PL = 9


def _prompt(uid: int, seed: int = 0):
    return np.random.default_rng(seed + uid).integers(1, VOCAB, PL)


def _serve(mod, bundle, params, reqs, slots, hook=None, eng=None):
    """(uid, prompt, max_new_tokens) triples through one engine; returns
    ({uid: output}, engine)."""
    if eng is None:
        eng = mod.Engine(bundle, params,
                         mod.EngineConfig(slots=slots, max_seq=32,
                                          prefill_len=PL),
                         logits_hook=hook)
    for uid, prompt, new in reqs:
        eng.submit(mod.Request(uid=uid, prompt=prompt, max_new_tokens=new))
    done = eng.run(max_ticks=200)
    return {r.uid: list(map(int, r.output)) for r in done}, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_on_fresh_slots(arch):
    """One wave of exact-length prompts in fresh slots, budgets that retire
    slots at different ticks: the reference's greedy tokens."""
    jb, jp, tb, tp = _models(arch)
    reqs = [(u, _prompt(u), 2 + 2 * u) for u in range(3)]
    got, eng = _serve(tengine, tb, tp, reqs, slots=3)
    want, jeng = _serve(jengine, jb, jp, reqs, slots=3)
    assert got == want
    assert eng.ticks == jeng.ticks
    with pytest.raises(ValueError, match="exact-length"):
        eng.submit(tengine.Request(uid=9, prompt=_prompt(9)[:PL - 1],
                                   max_new_tokens=2))
    with pytest.raises(ValueError, match="exact-length"):
        jeng.submit(jengine.Request(uid=9, prompt=_prompt(9)[:PL - 1],
                                    max_new_tokens=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_leaves_running_slots_bit_equal(arch):
    """A batched prefill into slot 1 leaves slot 0's every state tensor
    (the FFN's token shift included) bit-equal, and slot 0 goes on to the
    tokens it gives alone."""
    _, _, tb, tp = _models(arch)
    eng = tengine.Engine(tb, tp, tengine.EngineConfig(slots=2, max_seq=32,
                                                      prefill_len=PL))
    eng.submit(tengine.Request(uid=0, prompt=_prompt(0), max_new_tokens=6))
    eng.step()
    eng.step()
    before = [t[0].clone() for t in tengine._cache_leaves(eng.caches)]
    assert len(before) == sum(
        {"rglru": 2, "rwkv": 3, "local_attn": 2}[k]
        for k in tb.cfg.layer_kinds())
    eng.submit(tengine.Request(uid=1, prompt=_prompt(1), max_new_tokens=2))
    eng._admit()
    after = [t[0] for t in tengine._cache_leaves(eng.caches)]
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))
    crowded = {r.uid: r.output for r in eng.run()}
    alone, _ = _serve(tengine, tb, tp, [(0, _prompt(0), 6)], slots=2)
    assert crowded[0] == alone[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_equals_a_fresh_engine(arch):
    """A request admitted into a slot another request used starts from the
    recurrent state a fresh engine gives it (bit-equal after the prefill)
    and decodes its tokens: the port zeroes the admitted slot's recurrent
    state (the reference would start from the old one)."""
    _, _, tb, tp = _models(arch)
    first, eng = _serve(tengine, tb, tp, [(0, _prompt(0, 5), 5)], slots=1)
    assert eng.slot_req == [None]
    fresh = tengine.Engine(tb, tp, tengine.EngineConfig(slots=1, max_seq=32,
                                                        prefill_len=PL))
    for e in (eng, fresh):
        e.submit(tengine.Request(uid=1, prompt=_prompt(1), max_new_tokens=6))
        e._admit()
    states = [tengine._cache_leaves(e.caches, recurrent_only=True)
              for e in (eng, fresh)]
    assert states[0]
    assert all(torch.equal(a, b)
               for a, b in zip(*states, strict=True))
    second = {r.uid: r.output for r in eng.run()}
    assert second[1] == {r.uid: r.output for r in fresh.run()}[1]
    assert first[0] != second[1]


def test_hook_on_reduced_recurrentgemma_matches_jax(monkeypatch):
    """The kNN-LM hook over each package's own datastore of the reduced
    recurrentgemma-2b: the keys agree, and so do the mixed log-probs of
    the same hidden states and the neighbours' ids; the engine serves with
    the hook (its greedy tokens without the hook equal the reference's,
    test_engine_matches_jax_on_fresh_slots)."""
    jb, jp, tb, tp = _models("recurrentgemma-2b")
    corpus = np.random.default_rng(3).integers(1, VOCAB, (4, 20))
    jstore = jknnlm.build_datastore(jb, jp, corpus, m=4)
    monkeypatch.setattr(tknnlm, "FORWARD_BATCH", 3)   # two micro-batches
    tstore = tknnlm.build_datastore(tb, tp, corpus, m=4)
    assert tstore.index.n == jstore.index.n == 4 * 19
    order_t = np.argsort(tstore.index.point_ids.numpy())
    order_j = np.argsort(np.asarray(jstore.index.point_ids))
    np.testing.assert_allclose(tstore.index.data.numpy()[order_t],
                               np.asarray(jstore.index.data)[order_j],
                               **TOL_FP32)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, VOCAB)).astype(np.float32) * 3
    hidden = np.asarray(jstore.index.data)[order_j][[0, 30, 60]] + \
        rng.normal(size=(3, 64)).astype(np.float32) * 0.01
    jhook = jknnlm.KNNLMHook(store=jstore, k=4, lam=0.5)
    thook = tknnlm.KNNLMHook(store=tstore, k=4, lam=0.5)
    want = np.asarray(jhook(jnp.asarray(logits), jnp.asarray(hidden)))
    got = thook(torch.from_numpy(logits), torch.from_numpy(hidden)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    res = jsearch.knn_batch(jstore.index, jnp.asarray(hidden), 4)
    np.testing.assert_array_equal(thook.last_result.ids.numpy(),
                                  np.asarray(res.ids))
    hook = tknnlm.KNNLMHook(store=tstore, k=4, lam=0.3)
    out, _ = _serve(tengine, tb, tp, [(u, _prompt(u), 4) for u in range(2)],
                    slots=2, hook=hook)
    assert all(len(o) == 4 for o in out.values())
    assert hook.queries_served == 8
