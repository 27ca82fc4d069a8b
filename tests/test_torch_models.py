"""The port's LM substrate against the JAX package's on the CPU: layers,
the plain version of kernel #10 (against the reference's oracle and its
Pallas kernel in interpret mode), ``sdpa`` against ``sdpa_dense`` and
``sdpa_chunked``, and reduced starcoder2-3b ``forward_train``, ``prefill``
and ``decode_step``, the parameters carried across as numpy arrays.

Tolerances:

* fp32 (``compute_dtype=float32``): 2e-5 on attention outputs (the kernel
  test's fp32 tolerance; sums in another order), 1e-4 on hidden states
  and logits of the 2-layer model (the same rounding through two layers,
  the final LayerNorm and a 64-term unembedding, plus RoPE angles from
  fp32 ``theta ** x`` and sin/cos of another library).
* bf16: 2e-2 on attention outputs (the kernel test's bf16 tolerance: the
  reference rounds probabilities to bf16 before P.V, the kernel does not).
  Hidden states, caches and logits in bf16 are held loosely, to twice the
  reference's own bf16 error against its fp32 forward: XLA on the CPU and
  PyTorch round bf16 intermediates at different places (XLA fuses
  elementwise chains in fp32 and rounds once), so two bf16 forwards agree
  only as well as either agrees with fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.registry import build_model as jbuild_model

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.registry import build_model

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"fp32": 2e-5, "bf16": 2e-2}
MODEL_TOL_FP32 = dict(rtol=1e-4, atol=1e-4)

# test_kernels.py::test_flash_attention's seven cases, then
# recurrentgemma-2b's MQA at head dim 256 with a window.
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None),      # MHA causal
    (1, 8, 2, 64, 64, 32, True, None),      # GQA 4:1
    (2, 4, 1, 32, 32, 16, True, None),      # MQA
    (1, 4, 4, 64, 64, 32, False, None),     # bidirectional (encoder)
    (1, 4, 2, 64, 64, 32, True, 16),        # sliding window
    (2, 4, 2, 1, 96, 32, True, None),       # decode: 1 new token vs cache
    (1, 2, 2, 48, 48, 32, True, None),      # non-pow2 seq (padding path)
    (1, 2, 1, 40, 40, 256, True, 16),       # recurrentgemma: MQA, D 256
]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layers_match_jax(dtype):
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "fp32" else \
        dict(rtol=1e-2, atol=1e-2)
    x = _normal((2, 5, 4, 16), 0)
    jx, tx = _pair(x, dtype)
    # gelu is the tanh approximation in both (jax.nn.gelu's default).
    np.testing.assert_allclose(_np(tlayers._act("gelu")(tx)),
                               _np(jax.nn.gelu(jx)), **tol)
    pos = np.arange(10).reshape(2, 5).astype(np.int32) * 7
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e5)),
        _np(jlayers.apply_rope(jx, jnp.asarray(pos), 1e5)), **tol)
    scale, bias = _normal((16,), 1) + 1.0, _normal((16,), 2)
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(tx, torch.from_numpy(scale))),
        _np(jlayers.rms_norm(jx, jnp.asarray(scale))), **tol)
    np.testing.assert_allclose(
        _np(tlayers.layer_norm(tx, torch.from_numpy(scale),
                               torch.from_numpy(bias))),
        _np(jlayers.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))),
        **tol)
    table = _normal((jlayers.padded_vocab(300), 16), 3)
    assert tlayers.padded_vocab(300) == jlayers.padded_vocab(300) == 384
    toks = np.random.default_rng(4).integers(0, 300, (2, 7)).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    emb_t = tlayers.embed_lookup(torch.from_numpy(table),
                                 torch.from_numpy(toks), tdt)
    emb_j = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(toks), jdt)
    assert emb_t.dtype == tdt
    np.testing.assert_array_equal(_np(emb_t), _np(emb_j))
    logits_t = tlayers.unembed_logits(emb_t, torch.from_numpy(table))
    logits_j = jlayers.unembed_logits(emb_j, jnp.asarray(table))
    assert logits_t.dtype == torch.float32           # fp32 logits in bf16 too
    np.testing.assert_allclose(_np(logits_t), _np(logits_j), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Kernel #10: the plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,window", FLASH_CASES)
def test_flash_attention_plain_version_matches_jax(b, h, kh, sq, skv, d,
                                                   causal, window, dtype):
    jq, tq = _pair(_normal((b, h, sq, d), 10), dtype)
    jk, tk = _pair(_normal((b, kh, skv, d), 11), dtype)
    jv, tv = _pair(_normal((b, kh, skv, d), 12), dtype)
    before = tflash.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tflash.launches == before             # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = ATTN_TOL[dtype]
    want_ref = jref.attention(jq, jk, jv, causal=causal, window=window)
    want_pallas = pallas_flash(jq, jk, jv, causal=causal, window=window,
                               block_q=32, block_kv=32, interpret=True)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("h,kh,s,window", [(4, 2, 40, None), (4, 1, 33, 8)])
def test_sdpa_matches_dense_and_chunked(h, kh, s, window, dtype):
    """(B, S, H, D) layout in and out; the chunked path is forced with a
    small threshold and chunks that do not divide S."""
    jq, tq = _pair(_normal((2, s, h, 16), 20), dtype)
    jk, tk = _pair(_normal((2, s, kh, 16), 21), dtype)
    jv, tv = _pair(_normal((2, s, kh, 16), 22), dtype)
    got = tattn.sdpa(tq, tk, tv, causal=True, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    dense = jattn.sdpa_dense(jq, jk, jv, causal=True, window=window)
    chunked = jattn.sdpa(jq, jk, jv, causal=True, window=window,
                         dense_threshold=8, q_chunk=16, kv_chunk=16)
    tol = ATTN_TOL[dtype]
    for want in (dense, chunked):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# Reduced starcoder2-3b: forward, prefill, decode
# ---------------------------------------------------------------------------

VARIANTS = {
    "reduced": {},
    "local_attn": dict(block_pattern=("local_attn", "attn"), window=4),
    "scan_layers": dict(scan_layers=True),
}
B, S, S_MAX = 2, 10, 16


def _configs(variant: str, dtype: str):
    jdt, tdt = DTYPES[dtype]
    over = dict(VARIANTS[variant])
    jcfg = dataclasses.replace(jconfigs.get_reduced("starcoder2-3b"),
                               compute_dtype=jdt, **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced("starcoder2-3b"),
                               compute_dtype=tdt, **over)
    return jcfg, tcfg


_PARAMS: dict = {}


def _params(variant: str):
    """The reference's fp32 parameters for a variant (numpy tree).  The
    scan_layers variant stacks the reduced config's per-layer parameters
    into the (L, ...) layout its scanned stack reads: the reference's own
    init of a stacked spec takes the fan-in from the layers axis (1/sqrt(2)
    here, ROADMAP queue 3), which would make the bf16 comparison measure
    the sensitivity of a saturated softmax rather than the port."""
    if variant not in _PARAMS:
        if variant == "scan_layers":
            tree = dict(_params("reduced"))
            tree["layers"] = jax.tree.map(lambda *xs: np.stack(xs),
                                          *tree["layers"])
        else:
            jcfg, _ = _configs(variant, "fp32")
            tree = jax.tree.map(
                np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(0)))
        _PARAMS[variant] = tree
    return _PARAMS[variant]


def _inputs():
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 512, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return toks, pos


def _run(mod, cfg, params, device=None):
    """forward_train, prefill (hidden and every layer's k/v cache) and three
    decode steps (hidden and logits) of one package, as float32 numpy."""
    torch_side = mod is ttf
    arr = torch.from_numpy if torch_side else jnp.asarray
    toks, pos = _inputs()
    out = {"forward": mod.forward_train(cfg, params, arr(toks),
                                        arr(pos))[0]}
    if torch_side:
        caches = mod.init_cache(cfg, B, S_MAX, device=device)
    else:
        caches = mod.init_cache(cfg, B, S_MAX)
    out["prefill"], caches = mod.prefill(cfg, params, arr(toks), arr(pos),
                                         caches, arr(np.zeros((B,), np.int32)))
    for i in range(cfg.num_layers):
        if torch_side:   # the decode steps below write these in place
            k, v = (t.clone() for t in caches[i]["mixer"])
        elif isinstance(caches, dict):          # stacked (L, ...) caches
            k, v = caches["mixer"].k[i], caches["mixer"].v[i]
        else:
            k, v = caches[i]["mixer"]
        out[f"cache_k{i}"], out[f"cache_v{i}"] = k, v
    lengths = np.full((B,), S, np.int32)
    for step in range(3):    # past the local window's ring size
        lg, hd, caches = mod.decode_step(
            cfg, params, arr(toks[:, step:step + 1].copy()),
            arr(lengths[:, None].copy()), caches, arr(lengths))
        out[f"decode_hidden{step}"], out[f"decode_logits{step}"] = hd, lg
        lengths = lengths + 1
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reduced_starcoder2_matches_jax(variant, dtype):
    """fp32: within 1e-4.  bf16: the port's bf16 forward may differ from
    the reference's bf16 forward by at most twice the reference's own bf16
    error against its fp32 forward (max norms, plus one bf16 ulp at the
    tensor's scale), the tensor by tensor criterion of "as accurate as the
    reference in bf16"."""
    jcfg, tcfg = _configs(variant, dtype)
    tree = _params(variant)
    stacked = isinstance(tree["layers"], dict)
    assert stacked == (variant == "scan_layers")
    params = ttf.params_from_numpy(tcfg, tree, device="cpu")
    if stacked:   # every layer reads a view of the stacked tensor
        base = params["layers"][0]["mixer"]["wq"]._base
        assert base is not None
        assert params["layers"][1]["mixer"]["wq"]._base is base
    jparams = jax.tree.map(jnp.asarray, tree)
    got = _run(ttf, tcfg, params, device="cpu")
    want = _run(jtf, jcfg, jparams)
    assert got["forward"].dtype == DTYPES[dtype][1]
    assert got["decode_logits0"].dtype == torch.float32
    assert got["decode_logits0"].shape == (B, tcfg.vocab_size)
    if dtype == "bf16":
        truth = _run(jtf, _configs(variant, "fp32")[0], jparams)
    for key in want:
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, key
        if dtype == "fp32":
            np.testing.assert_allclose(g, w, err_msg=key, **MODEL_TOL_FP32)
            continue
        t32 = _np(truth[key])
        bound = (2.0 * float(np.abs(w - t32).max())
                 + 2.0 ** -8 * float(np.abs(t32).max()))
        assert float(np.abs(g - w).max()) <= bound, (key, bound)


def test_full_config_and_unported_kinds():
    cfg = tconfigs.get_config("starcoder2-3b")
    jcfg = jconfigs.get_config("starcoder2-3b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "ffn_kind", "act", "norm",
              "qkv_bias", "out_bias", "mlp_bias", "rope_theta",
              "tie_embeddings", "scan_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.compute_dtype == torch.bfloat16
    assert ttf.count_params(cfg) == jtf.count_params(jcfg)
    # Every config is ported: whisper-tiny (encoder-decoder,
    # tests/test_torch_encdec.py) and qwen2-vl-72b (M-RoPE,
    # tests/test_torch_mrope.py) build, at the reference's sizes; learned
    # positions run; a kind or a config type that does not exist raises.
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    for arch in ("whisper-tiny", "qwen2-vl-72b"):
        full = tconfigs.get_config(arch)
        assert build_model(full, device="cpu").count_params == \
            jbuild_model(jconfigs.get_config(arch)).count_params
        bundle = build_model(tconfigs.get_reduced(arch), device="cpu")
        assert bundle.extra_inputs and bundle.init(0)
    learned = dataclasses.replace(cfg, pos_embedding="learned",
                                  max_position=32)
    assert ttf.init_params(learned, device="cpu")["pos_embed"].shape == (
        32, cfg.d_model)
    assert len(ttf.init_cache(learned, 1, 8, device="cpu")) == \
        cfg.num_layers
    for bad in (dict(block_pattern=("conv",)), dict(ffn_kind="glu"),
                dict(pos_embedding="alibi")):
        with pytest.raises(ValueError, match="unknown"):
            ttf.init_params(dataclasses.replace(cfg, **bad), device="cpu")
    with pytest.raises(TypeError, match="unknown config type"):
        build_model(type("EncDecConfig", (), {})(), device="cpu")
    assert len(ttf.init_cache(dataclasses.replace(
        cfg, block_pattern=("rglru",), lru_width=8, num_layers=2), 1, 8,
        device="cpu")) == 2
    moe = tconfigs.get_reduced("qwen3-moe-30b-a3b")
    assert len(ttf.init_cache(moe, 1, 8, device="cpu")) == moe.num_layers


def test_port_init_follows_the_spec_rule():
    """Fan-in scaling of the port's own init (per-layer shapes), zeros and
    ones where the reference's specs put them; a seed fixes the draw."""
    cfg = tconfigs.get_reduced("starcoder2-3b")
    p = ttf.init_params(cfg, seed=3, device="cpu")
    again = ttf.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p["layers"][1]["ffn"]["w_in"],
                       again["layers"][1]["ffn"]["w_in"])
    wq = p["layers"][0]["mixer"]["wq"]
    assert wq.shape == (64, 4, 16)
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    assert p["embed"].shape == (512, 64)
    assert torch.equal(p["layers"][0]["mixer"]["bq"],
                       torch.zeros((4, 16)))
    assert torch.equal(p["final_norm"]["scale"], torch.ones(64))
    total = (p["embed"].numel() + 2 * 64
             + sum(t.numel() for lp in p["layers"] for sub in lp.values()
                   for t in sub.values()))
    assert total == ttf.count_params(cfg)
    # An expert stack (E, d, f) takes each expert's own fan-in: d for w_in
    # and w_gate, f for w_out (the reference's Spec reads E, ROADMAP §3).
    moe = dataclasses.replace(tconfigs.get_reduced("qwen3-moe-30b-a3b"),
                              d_model=128, moe_d_ff=32)
    ffn = ttf.init_params(moe, seed=3, device="cpu")["layers"][0]["ffn"]
    assert ffn["w_in"].shape == (8, 128, 32)
    for name, fan_in in (("w_in", 128), ("w_gate", 128), ("w_out", 32)):
        assert abs(float(ffn[name].std()) - fan_in ** -0.5) \
            < 0.02 * fan_in ** -0.5, name
    assert abs(float(ffn["router"].std()) - 128 ** -0.5) < 0.01
