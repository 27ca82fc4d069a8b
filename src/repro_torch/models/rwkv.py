"""RWKV-6 "Finch" (Peng et al. 2024) — attention-free time mixing with
data-dependent per-channel decay (port of ``repro.models.rwkv``).

Per head (head size N), with row vectors r_t, k_t, v_t and decay w_t:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state: N_key x N_value)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)      (u = per-channel bonus)

A sequence runs the reference's **chunked parallel form**: within a chunk
the cumulative log-decays L_t = sum_{s<=t} log w_s are formed once, and
the intra-chunk pair terms use exp(Lprev_t - L_s) with the exponent
difference formed first (always <= 0 for a valid pair); inter-chunk terms
flow through the carried state S with factors exp(L) <= 1.  Decode runs
the O(1) recurrence.

The pair terms of a chunk are a (B, C, C, H, N) fp32 tensor (1.07 GB at
B = 8, C = 128, H = 32, N = 64).  Without a graph the port makes it once
and turns it into the decays and then the products in place, where the
reference's jnp expression leaves the temporaries to XLA; under autograd
(training) it makes them out of place, which autograd needs.  Both forms
mask before ``exp`` (a masked pair's gradient is 0, not NaN) and give
the same bits.  The reference also ``jax.checkpoint``s each chunk; the
port does not: under the layer's own checkpoint its recompute keeps two
pair tensors a chunk for the backward (17.6 GB for rwkv6-1.6b's 32
chunks at 2 x 4096 tokens, a peak of 44.9 GB on an H100), and a chunk
checkpoint would cost a third forward of every chunk (18.6% of a step,
PERF.md §5).

Token shift ("ddlerp") follows the RWKV-6 low-rank form: a shared first
lerp, then a 5-way LoRA producing per-projection mix deltas for r/k/v/w/g.
The decay LoRA gives w_t = exp(-exp(w0 + tanh(x_w A_w) B_w)) per channel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Spec

Tensor = torch.Tensor

_MIX = ("r", "k", "v", "w", "g")


def rwkv_time_spec(d: int, head_dim: int, lora_r: int = 32,
                   decay_lora: int = 64) -> dict:
    """Time-mix parameters, name -> ``Spec``: the reference's specs."""
    return {
        "mu_first": Spec((d,), ("embed",), "zeros"),
        "mu": Spec((5, d), (None, "embed"), "zeros"),
        "lora_a": Spec((d, 5 * lora_r), ("fsdp", None), scale=0.01),
        "lora_b": Spec((5, lora_r, d), (None, None, "embed"), scale=0.01),
        "w_r": Spec((d, d), ("fsdp", "heads")),
        "w_k": Spec((d, d), ("fsdp", "heads")),
        "w_v": Spec((d, d), ("fsdp", "heads")),
        "w_g": Spec((d, d), ("fsdp", "heads")),
        "w_o": Spec((d, d), ("heads", "fsdp")),
        "decay_w0": Spec((d,), ("heads",), "zeros"),
        "decay_a": Spec((d, decay_lora), ("fsdp", None), scale=0.01),
        "decay_b": Spec((decay_lora, d), (None, "heads"), scale=0.01),
        "bonus_u": Spec((d,), ("heads",), "zeros"),
        "ln_scale": Spec((d,), ("heads",), "ones"),
        "ln_bias": Spec((d,), ("heads",), "zeros"),
    }


def rwkv_channel_spec(d: int, f: int) -> dict:
    return {
        "mu_k": Spec((d,), ("embed",), "zeros"),
        "mu_r": Spec((d,), ("embed",), "zeros"),
        "w_k": Spec((d, f), ("fsdp", "mlp")),
        "w_v": Spec((f, d), ("mlp", "fsdp")),
        "w_r": Spec((d, d), ("fsdp", None)),
    }


def _token_shift(x: Tensor, x_prev: Tensor | None):
    """(B,S,D) -> the previous step's tensor, with the carried boundary
    state (B,D), and the new boundary state (a copy of x's last step)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    shifted = torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return shifted, x[:, -1].clone()


def _ddlerp(p: dict, x: Tensor, shifted: Tensor) -> dict:
    """RWKV-6 data-dependent lerp: 5 mixed inputs (r, k, v, w, g)."""
    dt = x.dtype
    xx = shifted - x
    base = x + xx * p["mu_first"].to(dt)
    lr = p["lora_a"].shape[1] // 5
    lo = torch.tanh(base @ p["lora_a"].to(dt))             # (B,S,5r)
    lo = lo.reshape(*lo.shape[:-1], 5, lr)
    delta = torch.einsum("bsnr,nrd->bsnd", lo, p["lora_b"].to(dt))
    return {name: x + xx * (p["mu"][n].to(dt) + delta[..., n, :])
            for n, name in enumerate(_MIX)}


def _group_norm(x: Tensor, scale: Tensor, bias: Tensor, head_dim: int,
                eps: float = 64e-5) -> Tensor:
    """Per-head LayerNorm over the head channels (RWKV's GroupNorm)."""
    shape = x.shape
    xf = x.reshape(*shape[:-1], shape[-1] // head_dim, head_dim).to(
        torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    nrm = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return (nrm * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# WKV — chunked parallel form
# ---------------------------------------------------------------------------

def _wkv_chunk(r, k, v, logw, u, state):
    """One chunk of the WKV recurrence.

    r/k/v: (B, C, H, N); logw: (B, C, H, N) (<= 0); u: (H, N); state:
    (B, H, N, N) fp32.  Returns (o (B,C,H,N) fp32, new_state)."""
    logw = logw.to(torch.float32)
    el = torch.cumsum(logw, dim=1)                          # L_t
    el_prev = el - logw                                     # L_{t-1}
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))

    # inter-chunk: o_t += (r_t . exp(L_{t-1})) @ S
    o = torch.einsum("bchn,bhnm->bchm", rf * torch.exp(el_prev), state)

    # intra-chunk pairs s < t: A[t,s] = sum_n r[t,n] k[s,n]
    # exp(Lprev[t,n] - L[s,n]): exp(diff) (-inf off the causal pairs),
    # then the products; without a graph in one (B,C,C,H,N) tensor turned
    # in place.
    c = r.shape[1]
    pair = el_prev[:, :, None] - el[:, None, :]             # <= 0 valid
    causal = torch.arange(c, device=r.device)[:, None] > torch.arange(
        c, device=r.device)[None, :]
    causal = causal[None, :, :, None, None]
    if torch.is_grad_enabled():
        pair = torch.exp(torch.where(causal, pair, float("-inf")))
        pair = pair * rf[:, :, None] * kf[:, None, :]
    else:
        pair.masked_fill_(~causal, float("-inf"))
        pair.exp_()
        pair.mul_(rf[:, :, None]).mul_(kf[:, None, :])
    att = pair.sum(-1).permute(0, 1, 3, 2)                  # (B,T,H,S)
    del pair
    # the diagonal (s = t) carries the bonus u instead of the decay
    att_diag = (rf * u.to(torch.float32) * kf).sum(-1)      # (B,T,H)
    eye = torch.eye(c, device=r.device)
    att = att + att_diag[:, :, :, None] * eye[None, :, None, :]
    o = o + torch.einsum("bths,bshn->bthn", att, vf)

    # state update: S' = diag(exp(L_C)) S + sum_s (k_s exp(L_C - L_s))^T v_s
    tail = el[:, -1:]                                       # (B,1,H,N)
    k_scaled = kf * torch.exp(tail - el)                    # <= 1 factors
    new_state = (torch.exp(tail[:, 0])[..., None] * state
                 + torch.einsum("bshn,bshm->bhnm", k_scaled, vf))
    return o, new_state


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 128):
    """Full-sequence WKV.  All of r/k/v/logw: (B, S, H, N); a ragged last
    chunk runs at its own length."""
    s = r.shape[1]
    chunk = min(chunk, s)
    outs = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        o, state = _wkv_chunk(r[:, c0:c1], k[:, c0:c1], v[:, c0:c1],
                              logw[:, c0:c1], u, state)
        outs.append(o)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, state


def wkv_step(r, k, v, logw, u, state):
    """Decode step.  r/k/v/logw (B,H,N); state (B,H,N,N) fp32."""
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]                # (B,H,N,N)
    o = torch.einsum("bhn,bhnm->bhm", rf,
                     state + u.to(torch.float32)[..., None] * kv)
    new_state = torch.exp(logw.to(torch.float32))[..., None] * state + kv
    return o, new_state


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def apply_rwkv_time(p: dict, x: Tensor, head_dim: int,
                    state: dict | None = None, chunk: int = 128):
    """Time-mix block.  x (B,S,D) -> (y, new_state); state: {"shift":
    (B,D), "wkv": (B,H,N,N) fp32} or None."""
    b, s, d = x.shape
    h = d // head_dim
    dt = x.dtype
    shifted, shift_out = _token_shift(
        x, None if state is None else state["shift"])
    mx = _ddlerp(p, x, shifted)

    r = (mx["r"] @ p["w_r"].to(dt)).reshape(b, s, h, head_dim)
    k = (mx["k"] @ p["w_k"].to(dt)).reshape(b, s, h, head_dim)
    v = (mx["v"] @ p["w_v"].to(dt)).reshape(b, s, h, head_dim)
    g = F.silu(mx["g"] @ p["w_g"].to(dt))

    dw = torch.tanh(mx["w"] @ p["decay_a"].to(dt)) @ p["decay_b"].to(dt)
    logw = -torch.exp(torch.clamp(
        p["decay_w0"].to(torch.float32) + dw.to(torch.float32),
        -12.0, 6.0))                                        # (B,S,D) <= 0
    logw = logw.reshape(b, s, h, head_dim)
    u = p["bonus_u"].to(torch.float32).reshape(h, head_dim)

    wkv0 = (torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                        device=x.device)
            if state is None else state["wkv"])
    if s == 1 and state is not None:
        o, wkv = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, wkv0)
        o = o[:, None]
    else:
        o, wkv = wkv_chunked(r, k, v, logw, u, wkv0, chunk=chunk)

    o = o.reshape(b, s, d).to(dt)
    o = _group_norm(o, p["ln_scale"], p["ln_bias"], head_dim) * g
    y = o @ p["w_o"].to(dt)
    return y, {"shift": shift_out, "wkv": wkv}


def apply_rwkv_channel(p: dict, x: Tensor, state: dict | None = None):
    """Channel-mix block (squared-ReLU FFN with token shift)."""
    dt = x.dtype
    shifted, shift_out = _token_shift(
        x, None if state is None else state["shift"])
    xx = shifted - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ p["w_k"].to(dt)))
    rr = torch.sigmoid(xr @ p["w_r"].to(dt))
    return rr * (kk @ p["w_v"].to(dt)), {"shift": shift_out}


def rwkv_state_zeros(b: int, d: int, head_dim: int, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    dev = resolve_device(device, meta=True)
    h = d // head_dim
    return {
        "time": {"shift": torch.zeros((b, d), dtype=dtype, device=dev),
                 "wkv": torch.zeros((b, h, head_dim, head_dim),
                                    dtype=torch.float32, device=dev)},
        "channel": {"shift": torch.zeros((b, d), dtype=dtype,
                                         device=dev)},
    }


def rwkv_state_axes() -> dict:
    """The logical axes of :func:`rwkv_state_zeros`' state."""
    return {"time": {"shift": ("batch", "embed"),
                     "wkv": ("batch", "heads", None, None)},
            "channel": {"shift": ("batch", "embed")}}
