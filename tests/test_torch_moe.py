"""The port's MoE FFN and the five MoE and dense configs against the JAX
package's on the CPU: routing (ties to the lower expert, a zero weight,
the aux loss), the slot assignment rebuilt into the reference's one-hot
``dispatch`` / ``combine`` tensors (with drops, and a decode-shaped group
of capacity 1), ``apply_moe`` with and without llama4's shared expert,
the five reduced configs' forward / prefill / decode (one imported from a
stacked ``scan_layers`` tree), the full configs' parameter counts, and
the serving engine and the kNN-LM hook on reduced qwen3-moe-30b-a3b with
tokens dropped in decode.  The same numpy inputs, made from a seed, go to
both packages.

Tolerances:

* Router weights: rtol 1e-6 (the two libraries' fp32 ``exp`` differ in
  the last bit on about a tenth of inputs; the ids are equal and a planted
  exact tie goes to the lower expert in both).  The aux loss: 1e-6.
* ``dispatch`` / ``combine`` rebuilt from the port's slots on the
  reference's routes: bit-equal.
* fp32 outputs and hidden states: rtol/atol 1e-4 (the LM tests' rule:
  sums in another order through a few layers); ``apply_moe`` alone
  2e-5.
* bf16: twice the reference's own bf16 error against its fp32 result plus
  one bf16 ulp at the tensor's scale (tests/test_torch_models.py's rule).
* Greedy tokens run in fp32 compute and compare equal.

Every comparison first checks that both packages chose the same experts:
a choice that flips at a near tie moves an output far past any fp32
tolerance, so an assertion on the routes comes before the one on the
values.  The JAX side runs under ``jax.jit``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.layers import init_tree, mlp_spec
from repro.models.registry import build_model as jbuild_model
from repro.serve import engine as jengine

from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import knnlm as tknnlm

ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "qwen2.5-32b",
         "qwen3-32b", "phi3-medium-14b")
MOE_ARCHS = ARCHS[:2]
TOL_FP32 = dict(rtol=1e-4, atol=1e-4)
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


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


class RouteSpy:
    """Wraps a package's ``route`` and keeps every call's expert ids, in
    the order the calls run (through a debug callback under ``jax.jit``)."""

    def __init__(self, module, monkeypatch):
        self.ids = []
        inner = module.route

        def keep(ids):
            self.ids.append(np.asarray(ids, np.int64))

        def spy(logits, cfg):
            w, i, aux = inner(logits, cfg)
            if isinstance(i, torch.Tensor):
                keep(i.numpy())
            else:
                jax.debug.callback(keep, i, ordered=True)
            return w, i, aux

        monkeypatch.setattr(module, "route", spy)


# ---------------------------------------------------------------------------
# Routing and slots
# ---------------------------------------------------------------------------

def _logits(g, s, e, seed):
    lg = _normal((g, s, e), seed, 2.0)
    lg[0, 0, :] = -5.0
    lg[0, 0, [2, min(6, e - 1)]] = 3.0      # an exact tie for the first place
    if e > 4:
        lg[0, 1, :] = -5.0
        lg[0, 1, [1, 3, 4]] = (4.0, 1.0, 1.0)   # a tie at the top-2 boundary
    lg[-1, -1, :] = -300.0                  # exp underflows: weights of 0
    lg[-1, -1, 0] = 0.0
    return lg


@pytest.mark.parametrize("order", ["topk_then_softmax", "softmax_topk"])
@pytest.mark.parametrize("g,s,e,k", [(3, 16, 8, 2), (2, 8, 128, 8),
                                     (2, 12, 4, 1)])
def test_route_matches_jax(g, s, e, k, order):
    jcfg, tcfg = _cfgs(num_experts=e, top_k=k, router_softmax_order=order)
    lg = _logits(g, s, e, seed=e + k)
    wj, ij, auxj = jax.jit(jmoe.route, static_argnums=1)(jnp.asarray(lg),
                                                         jcfg)
    wt, it, auxt = tmoe.route(torch.from_numpy(lg), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert wt.dtype == torch.float32 and it.dtype == torch.int64
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-30)
    assert abs(float(auxt) - float(auxj)) <= 1e-6
    # The ties went to the lower expert index, in both.
    assert it[0, 0, 0] == 2 and (k == 1 or it[0, 0, 1] == min(6, e - 1))
    if e > 4 and k == 2:
        assert it[0, 1].tolist() == [1, 3]
    if k > 1:
        assert float(wt[-1, -1, 1]) == 0.0 == float(np.asarray(wj)[-1, -1, 1])


def _rebuild(top_w, top_i, slot, keep, e, c):
    """The reference's one-hot (G, S, E, C) dispatch and combine from the
    port's slots."""
    g, s, _ = top_i.shape
    disp = np.zeros((g, s, e, c), np.float32)
    comb = np.zeros_like(disp)
    gi, si, ki = np.nonzero(keep)
    ei, ci = top_i[gi, si, ki], slot[gi, si, ki]
    disp[gi, si, ei, ci] = 1.0
    comb[gi, si, ei, ci] = top_w[gi, si, ki]
    return disp, comb


@pytest.mark.parametrize("g,s,e,k,cf,drops", [
    (3, 16, 8, 2, 8.0, False),      # the reduced configs' factor: no drop
    (3, 16, 8, 2, 1.0, True),       # a lowered factor: tokens drop
    (2, 24, 4, 1, 1.25, True),      # llama4's top-1
    (1, 8, 128, 8, 1.25, True),     # a decode tick of 8 slots: capacity 1
])
def test_dispatch_combine_rebuilt_bit_equal(g, s, e, k, cf, drops):
    jcfg, tcfg = _cfgs(num_experts=e, top_k=k, capacity_factor=cf,
                       group_tokens=s)
    c = jmoe._capacity(jcfg, s)
    assert c == tmoe._capacity(tcfg, s)
    if (s, e, k) == (8, 128, 8):
        assert c == 1
    lg = _logits(g, s, e, seed=11)
    if drops:       # crowd one expert so the capacity bites
        lg[:, :, 1] += 6.0
    wj, ij, _ = jmoe.route(jnp.asarray(lg), jcfg)
    disp, comb = jax.jit(jmoe.dispatch_combine, static_argnums=2)(wj, ij,
                                                                  jcfg)
    top_w, top_i = np.array(wj), np.array(ij).astype(np.int64)
    slot, keep = tmoe.assign_slots(torch.from_numpy(top_w),
                                   torch.from_numpy(top_i), tcfg)
    got_d, got_c = _rebuild(top_w, top_i, slot.numpy(), keep.numpy(), e, c)
    np.testing.assert_array_equal(got_d, np.asarray(disp))
    np.testing.assert_array_equal(got_c, np.asarray(comb))
    dropped = int((~keep.numpy() & (top_w > 0)).sum())
    assert (dropped > 0) == drops
    assert int(keep.sum()) == int(np.asarray(disp).sum())


def test_group_size_capacity_and_flops_match_jax():
    for total in (1, 7, 8, 27, 96, 4096, 8192, 1000):
        for target in (1, 8, 32, 512):
            assert tmoe._group_size(total, target) == \
                jmoe._group_size(total, target)
    for e, k, cf, s in ((128, 8, 1.25, 512), (128, 8, 1.25, 8),
                        (16, 1, 1.25, 512), (8, 2, 8.0, 27), (4, 1, 0.5, 3)):
        jcfg, tcfg = _cfgs(num_experts=e, top_k=k, capacity_factor=cf)
        assert tmoe._capacity(tcfg, s) == jmoe._capacity(jcfg, s)
        assert tmoe._capacity(tcfg) == jmoe._capacity(jcfg)
        for shared in (0, 8192):
            assert tmoe.moe_flops_per_token(2048, 768, tcfg,
                                            shared_f=shared) \
                == jmoe.moe_flops_per_token(2048, 768, jcfg, shared_f=shared)
    assert dataclasses.asdict(tmoe.MoEConfig(num_experts=3, top_k=1)) == \
        dataclasses.asdict(jmoe.MoEConfig(num_experts=3, top_k=1))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tmoe.MoEConfig(num_experts=3, top_k=1).top_k = 2


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

D, F, E = 32, 48, 8


def _moe_params(shared: bool):
    spec = jmoe.moe_spec(D, F, E)
    if shared:
        spec["shared"] = mlp_spec(D, 40, gated=True)
    return jax.tree.map(np.asarray, init_tree(jax.random.PRNGKey(1), spec))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shared", [False, True])
def test_apply_moe_matches_jax(shared, dtype, monkeypatch):
    """Groups of 16 of 48 tokens, top-2 of 8 at capacity factor 1.0: tokens
    drop.  fp32 within 2e-5; bf16 within the bf16 rule."""
    jcfg, tcfg = _cfgs(num_experts=E, top_k=2, capacity_factor=1.0,
                       group_tokens=16)
    tree = _moe_params(shared)
    x = _normal((2, 24, D), 5)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def jrun(dt):
        p = jax.tree.map(jnp.asarray, tree)
        fn = jax.jit(lambda p, x: jmoe.apply_moe(
            {k: v for k, v in p.items() if k != "shared"}, x, jcfg,
            shared_mlp=p.get("shared")))
        return fn(p, jnp.asarray(x, dt))

    spy_j, spy_t = RouteSpy(jmoe, monkeypatch), RouteSpy(tmoe, monkeypatch)
    yj, auxj = jrun(jdt)
    p = _torch_tree(tree)
    yt, auxt = tmoe.apply_moe({k: v for k, v in p.items() if k != "shared"},
                              torch.from_numpy(x).to(tdt), tcfg,
                              shared_mlp=p.get("shared"))
    np.testing.assert_array_equal(spy_t.ids[0], spy_j.ids[0])
    assert yt.dtype == tdt and yt.shape == (2, 24, D)
    assert abs(float(auxt) - float(auxj)) <= 1e-6
    if dtype == "fp32":
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2e-5, atol=2e-5)
    else:
        _close_bf16(yt, yj, jrun(jnp.float32)[0])
    # Tokens dropped: some of the 96 assignments are past the capacity.
    slot, keep = tmoe.assign_slots(*tmoe.route(
        (torch.from_numpy(x).to(tdt).float().reshape(3, 16, D)
         @ p["router"]), tcfg)[:2], tcfg)
    assert 0 < int((~keep).sum()) < keep.numel()


# ---------------------------------------------------------------------------
# Reduced models: forward, prefill, decode
# ---------------------------------------------------------------------------

MB, MS, M_MAX = 2, 10, 16
_ONCE: dict = {}


def _configs(arch: str, dtype: str = "fp32", **over):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jconfigs.get_reduced(arch),
                                compute_dtype=jdt, **over),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                compute_dtype=tdt, **over))


def _params(arch: str, **over):
    """The reference's fp32 parameters of the reduced config (numpy)."""
    key = ("params", arch, tuple(sorted(over)))
    if key not in _ONCE:
        jcfg, _ = _configs(arch, **over)
        init = jax.jit(functools.partial(jtf.init_params, jcfg))
        _ONCE[key] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    return _ONCE[key]


def _run(mod, cfg, params, serve: bool = True):
    """forward_train (hidden and aux), then unless ``serve`` is False
    prefill and two decode steps (hidden, logits), as float32 numpy."""
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
    hidden, aux = forward(params, arr(toks), arr(pos))
    out = {"forward": hidden, "aux": aux}
    if not serve:
        return {k: _np(v) for k, v in out.items()}
    caches = (mod.init_cache(cfg, MB, M_MAX, device="cpu") if torch_side
              else mod.init_cache(cfg, MB, M_MAX))
    out["prefill"], caches = prefill(params, arr(toks), arr(pos), caches,
                                     arr(np.zeros((MB,), np.int32)))
    lengths = np.full((MB,), MS, np.int32)
    for step in range(2):
        lg, hd, caches = decode(
            params, arr(toks[:, step:step + 1].copy()),
            arr(lengths[:, None].copy()), caches, arr(lengths))
        out[f"decode_hidden{step}"], out[f"decode_logits{step}"] = hd, lg
        lengths = lengths + 1
    return {k: _np(v) for k, v in out.items()}


def _jax_run(arch: str, dtype: str, tree, serve: bool = True,
             **over) -> dict:
    key = ("run", arch, dtype, tuple(sorted(over)), serve)
    if key not in _ONCE:
        _ONCE[key] = _run(jtf, _configs(arch, dtype, **over)[0],
                          jax.tree.map(jnp.asarray, tree), serve)
    return _ONCE[key]


def _compare_runs(got: dict, want: dict, truth: dict | None = None):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].shape == want[key].shape, key
        if truth is None:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **TOL_FP32)
        else:
            _close_bf16(got[key], want[key], truth[key], key)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_match_jax(arch, monkeypatch):
    """fp32: forward_train's hidden states and aux loss (0.0 for the dense
    configs); the MoE configs also through prefill and two decode steps
    (groups of one token a slot), every MoE layer's experts the
    reference's.  The dense configs' prefill and decode run starcoder2's
    code (tests/test_torch_models.py) with qkv_bias / qk_norm, which the
    forward covers."""
    _, tcfg = _configs(arch)
    tree = _params(arch)
    serve = arch in MOE_ARCHS
    spy_j, spy_t = RouteSpy(jmoe, monkeypatch), RouteSpy(tmoe, monkeypatch)
    want = _run(jtf, _configs(arch)[0], jax.tree.map(jnp.asarray, tree),
                serve)
    _ONCE[("run", arch, "fp32", (), serve)] = want
    got = _run(ttf, tcfg, ttf.params_from_numpy(tcfg, tree, device="cpu"),
               serve)
    if arch in MOE_ARCHS:
        # forward (2 layers), prefill (2), two decode steps (2 each); the
        # jitted reference traced each program once.
        assert len(spy_t.ids) == 8 and len(spy_j.ids) == 8
        for a, b in zip(spy_t.ids, spy_j.ids, strict=True):
            np.testing.assert_array_equal(a, b)
        assert float(got["aux"]) > 0
    else:
        assert not spy_t.ids and float(got["aux"]) == 0.0
    _compare_runs(got, want)


def test_reduced_qwen3_moe_bf16_matches_jax():
    """The served dtype: bf16 compute within the bf16 rule."""
    arch = "qwen3-moe-30b-a3b"
    _, tcfg = _configs(arch, "bf16")
    tree = _params(arch)
    got = _run(ttf, tcfg, ttf.params_from_numpy(tcfg, tree, device="cpu"))
    _compare_runs(got, _jax_run(arch, "bf16", tree),
                  truth=_jax_run(arch, "fp32", tree))


def test_qwen3_moe_scan_layers_imports_the_stacked_tree():
    """qwen3-moe-30b-a3b as published runs ``scan_layers=True``: the
    reference stacks its parameters, the experts' as (L, E, d, f); the
    port imports the stacked tree (each layer a view of it) and matches
    the reference's scanned forward."""
    arch = "qwen3-moe-30b-a3b"
    _, tcfg = _configs(arch, scan_layers=True)
    tree = _params(arch, scan_layers=True)
    assert tree["layers"]["ffn"]["w_in"].shape == (2, 8, 64, 96)
    params = ttf.params_from_numpy(tcfg, tree, device="cpu")
    base = params["layers"][0]["ffn"]["w_in"]._base
    assert base is not None and base.shape == (2, 8, 64, 96)
    assert params["layers"][1]["ffn"]["w_out"].shape == (8, 96, 64)
    got = _run(ttf, tcfg, params, serve=False)
    want = _jax_run(arch, "fp32", tree, serve=False, scan_layers=True)
    _compare_runs(got, want)


def test_full_configs_and_parameter_counts():
    fields = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "block_pattern", "ffn_kind",
              "act", "norm", "qkv_bias", "out_bias", "mlp_bias", "qk_norm",
              "rope_theta", "window", "moe_d_ff", "shared_expert_ff",
              "pos_embedding", "tie_embeddings", "scan_layers")
    for arch in ARCHS:
        for get in ("get_config", "get_reduced"):
            cfg = getattr(tconfigs, get)(arch)
            jcfg = getattr(jconfigs, get)(arch)
            for f in fields:
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, get, f)
            assert (cfg.moe is None) == (jcfg.moe is None)
            if cfg.moe is not None:
                assert isinstance(cfg.moe, tmoe.MoEConfig)
                assert dataclasses.asdict(cfg.moe) == \
                    dataclasses.asdict(jcfg.moe)
            assert ttf.count_params(cfg) == jtf.count_params(jcfg)
            assert ttf.active_params(cfg) == jtf.active_params(jcfg)
        cfg = tconfigs.get_config(arch)
        assert cfg.compute_dtype == torch.bfloat16
        assert tbuild_model(cfg, device="cpu").count_params == \
            ttf.count_params(cfg)
    full = tconfigs.get_config("qwen3-moe-30b-a3b")
    assert ttf.count_params(full) == 30_532_122_624
    assert ttf.count_params(dataclasses.replace(full, num_layers=16)) == \
        10_592_262_144
    assert ttf.active_params(full) < ttf.count_params(full) // 8


def test_moe_init_follows_the_per_expert_fan_in():
    """The port's own init of an MoE layer: the router at 1/sqrt(d), each
    expert's w_in and w_gate at 1/sqrt(d) and w_out at 1/sqrt(f) (their
    own first dims, not the experts axis the reference's Spec reads,
    ROADMAP §3); llama4's shared expert a gated MLP; the tree's size is
    ``count_params``."""
    cfg = dataclasses.replace(tconfigs.get_reduced("llama4-scout-17b-a16e"),
                              d_model=256, moe_d_ff=64)
    p = ttf.init_params(cfg, seed=2, device="cpu")
    ffn = p["layers"][0]["ffn"]
    assert ffn["w_in"].shape == (4, 256, 64)
    assert ffn["w_out"].shape == (4, 64, 256)
    assert ffn["router"].shape == (256, 4)
    for name, fan_in in (("w_in", 256), ("w_gate", 256), ("w_out", 64)):
        for e in range(4):
            assert abs(float(ffn[name][e].std()) - fan_in ** -0.5) \
                < 0.05 * fan_in ** -0.5, (name, e)
    assert abs(float(ffn["router"].std()) - 256 ** -0.5) < 0.01
    assert set(ffn["shared"]) == {"w_in", "w_gate", "w_out"}
    again = ttf.init_params(cfg, seed=2, device="cpu")
    assert torch.equal(again["layers"][1]["ffn"]["w_gate"],
                       p["layers"][1]["ffn"]["w_gate"])

    def size(tree):
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(size(v) for v in tree)
        return tree.numel()

    assert size(p) == ttf.count_params(cfg)


def test_moe_config_without_moe_raises():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen3-32b"),
                              ffn_kind="moe")
    with pytest.raises(ValueError, match="MoEConfig"):
        ttf.check_supported(cfg)


# ---------------------------------------------------------------------------
# Serving: the engine with drops in decode, and the kNN-LM hook
# ---------------------------------------------------------------------------

PL = 9
DROP_CF = 1.0        # capacity 1 for a decode tick of 3 slots (top-2 of 8)


def _models(**over):
    key = ("models", tuple(sorted(over.items())))
    if key not in _ONCE:
        arch = "qwen3-moe-30b-a3b"
        jcfg, tcfg = _configs(arch)
        if over:
            moe_kw = dict(dataclasses.asdict(jcfg.moe), **over)
            jcfg = dataclasses.replace(jcfg, moe=jmoe.MoEConfig(**moe_kw))
            tcfg = dataclasses.replace(tcfg, moe=tmoe.MoEConfig(**moe_kw))
        tree = _params(arch)
        _ONCE[key] = (jbuild_model(jcfg), jax.tree.map(jnp.asarray, tree),
                      tbuild_model(tcfg, device="cpu"),
                      ttf.params_from_numpy(tcfg, tree, device="cpu"))
    return _ONCE[key]


def _serve(mod, bundle, params, reqs, slots, hook=None):
    eng = mod.Engine(bundle, params,
                     mod.EngineConfig(slots=slots, max_seq=32,
                                      prefill_len=PL),
                     logits_hook=hook)
    for uid, prompt, new in reqs:
        eng.submit(mod.Request(uid=uid, prompt=prompt, max_new_tokens=new))
    done = eng.run(max_ticks=200)
    return {r.uid: list(map(int, r.output)) for r in done}, eng


def _requests():
    """Right-padded prompts of 4-9 tokens, budgets that retire slots at
    different ticks, a second wave into used slots."""
    rng = np.random.default_rng(3)
    return [(u, rng.integers(1, VOCAB, 4 + u % 6), 3 + 2 * (u % 3))
            for u in range(5)]


def test_engine_with_drops_matches_jax(monkeypatch):
    """Reduced qwen3-moe-30b-a3b at capacity factor 1.0: a decode tick of 3
    slots gives each expert one slot, so tokens drop in decode (and in the
    right-padded prefill, whose pad rows route and take capacity, as in
    the reference).  The greedy tokens equal the reference engine's."""
    jb, jp, tb, tp = _models(capacity_factor=DROP_CF)
    drops = {"decode": 0, "prefill": 0}
    inner = tmoe.assign_slots

    def counting(top_w, top_i, cfg):
        slot, keep = inner(top_w, top_i, cfg)
        kind = "decode" if top_i.shape[1] == 3 else "prefill"
        drops[kind] += int((~keep).sum())
        return slot, keep

    monkeypatch.setattr(tmoe, "assign_slots", counting)
    reqs = _requests()
    got, eng = _serve(tengine, tb, tp, reqs, slots=3)
    want, jeng = _serve(jengine, jb, jp, reqs, slots=3)
    assert got == want
    assert eng.ticks == jeng.ticks
    assert drops["decode"] > 0 and drops["prefill"] > 0, drops


def test_datastore_and_hook_on_reduced_qwen3_moe(monkeypatch):
    """The kNN-LM datastore of reduced qwen3-moe-30b-a3b: its keys are the
    reference's forward over the corpus (the port's forward runs in
    batches of 3 sequences, the reference's in one; at the reduced
    config's capacity factor of 8 no token drops, so the groups do not
    matter) and its values the next tokens; the engine serves
    right-padded prompts with the hook on every sampled token (the hook's
    mixture against the reference's: tests/test_torch_serve.py)."""
    jb, jp, tb, tp = _models()
    corpus = np.random.default_rng(4).integers(1, VOCAB, (4, 20))
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (4, 20))
    hidden, _ = jax.jit(jb.forward_train)(
        jp, {"tokens": jnp.asarray(corpus, jnp.int32),
             "positions": jnp.asarray(pos)})
    monkeypatch.setattr(tknnlm, "FORWARD_BATCH", 3)   # two micro-batches
    tstore = tknnlm.build_datastore(tb, tp, corpus, m=4)
    assert tstore.index.n == 4 * 19
    order = np.argsort(tstore.index.point_ids.numpy())
    np.testing.assert_allclose(tstore.index.data.numpy()[order],
                               _np(hidden[:, :-1]).reshape(-1, 64),
                               **TOL_FP32)
    np.testing.assert_array_equal(tstore.next_tokens,
                                  corpus[:, 1:].reshape(-1))
    hook = tknnlm.KNNLMHook(store=tstore, k=4, lam=0.3)
    out, _ = _serve(tengine, tb, tp, _requests()[:3], slots=2, hook=hook)
    assert sorted(out) == [0, 1, 2]
    assert hook.queries_served == sum(r[2] for r in _requests()[:3])


def test_moe_layer_aux_is_dropped_in_prefill_and_decode():
    """prefill and decode return no aux term, as in the reference; the
    forward's aux is the sum over layers of each layer's weighted term."""
    _, _, tb, tp = _models()
    cfg = tb.cfg
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, VOCAB, (2, 8)))
    pos = torch.arange(8)[None].expand(2, 8)
    hidden, aux = tb.forward_train(tp, {"tokens": toks, "positions": pos})
    out = tb.prefill(tp, {"tokens": toks, "positions": pos},
                     tb.init_cache(2, 16), torch.zeros(2, dtype=torch.int32))
    assert len(out) == 2 and torch.equal(out[0], hidden)
    x = tlayers.embed_lookup(tp["embed"], toks, cfg.compute_dtype)
    total = 0.0
    for kind, lp in zip(cfg.layer_kinds(), tp["layers"], strict=True):
        x, a, _ = ttf._apply_layer(cfg, kind, lp, x, positions=pos,
                                   cache=None, lengths=None)
        total = total + a
    assert float(aux) == float(total) > 0
