"""RG-LRU recurrence block (RecurrentGemma / Griffin, De et al. 2024; port
of ``repro.models.rglru``).

The recurrence is a *diagonal* data-dependent linear RNN:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (per-channel decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The pair (a, u) composes associatively, so :func:`rglru_scan` runs the
whole sequence in log2(S) doubling steps of whole-tensor ops (no loop over
the steps).  Its sums combine in another order than
``jax.lax.associative_scan``'s, so it agrees with the reference to fp32
rounding, not to the bit.

The Griffin recurrent block wraps the RG-LRU with the temporal conv1d
(width 4) and the gated linear projections:

    x -> [linear -> conv1d -> RG-LRU] * gelu(linear gate) -> linear out

Gates and recurrence in fp32, ``a_t`` in log-space (``sqrt(1 - a^2)`` as
``sqrt(-expm1(2 log_a))``), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import Spec

Tensor = torch.Tensor

_C = 8.0  # the paper's fixed decay sharpness


def rglru_spec(d: int, width: int, conv_width: int = 4) -> dict:
    """Griffin recurrent block parameters, name -> ``Spec``; d = d_model,
    width = lru_width.  The reference's specs."""
    return {
        "w_in": Spec((d, width), ("fsdp", "state")),
        "w_gate": Spec((d, width), ("fsdp", "state")),
        "w_out": Spec((width, d), ("state", "fsdp")),
        "conv_w": Spec((conv_width, width), (None, "state"), scale=0.3),
        "conv_b": Spec((width,), ("state",), "zeros"),
        "lam": Spec((width,), ("state",), "uniform_lambda"),
        "w_a": Spec((width, width), ("state", None)),
        "b_a": Spec((width,), ("state",), "zeros"),
        "w_x": Spec((width, width), ("state", None)),
        "b_x": Spec((width,), ("state",), "zeros"),
    }


def _lambda_init(lam_raw: Tensor) -> Tensor:
    """Map an init-normal param to the paper's a in [0.9, 0.999]."""
    u = torch.sigmoid(lam_raw)
    a_target = 0.9 + 0.099 * u
    # softplus(Lambda) = -log(a)/c  =>  Lambda = softplus^-1(-log a / c)
    sp = -torch.log(a_target) / _C
    return torch.log(torch.expm1(torch.clamp(sp, min=1e-8)))


def conv1d_causal(x: Tensor, w: Tensor, b: Tensor,
                  state: Tensor | None = None):
    """Causal temporal conv.  x (B,S,W), w (K,W).  Returns (y, new_state):
    ``state`` carries the trailing K-1 steps (None: zero history)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)               # (B, S+K-1, W)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i].to(x.dtype)
    # A copy, so the state does not hold the whole (B, S+K-1, W) tensor.
    new_state = xp[:, -(k - 1):].clone() if k > 1 else state
    return y + b.to(x.dtype), new_state


def _decay_and_input(x: Tensor, r: Tensor, i: Tensor, lam: Tensor):
    """fp32 (a, u) of h_t = a_t h_{t-1} + u_t."""
    log_a = -_C * F.softplus(lam.to(torch.float32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))       # sqrt(1 - a^2)
    return a, beta * (i * x.to(torch.float32))


def rglru_scan(x: Tensor, r: Tensor, i: Tensor, lam: Tensor,
               h0: Tensor | None = None):
    """The RG-LRU recurrence over a full sequence.  x/r/i: (B, S, W); lam:
    (W,) raw parameter; h0: (B, W) carried state.  Returns (h (B,S,W) fp32,
    h_last (B,W)).

    A doubling (Hillis-Steele) scan: after the step of offset o, position t
    holds the composition of steps (t-2o, t]; each step combines
    (a1, u1) then (a2, u2) into (a1 a2, a2 u1 + u2), the reference's
    combine.  Every step makes new tensors (nothing is written in place),
    so autograd runs through it."""
    a, u = _decay_and_input(x, r, i, lam)
    if h0 is not None:
        # fold the carried state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0.to(torch.float32)[:, None], u], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        u_next = torch.cat(
            [u[:, :off], u[:, off:] + a[:, off:] * u[:, :-off]], dim=1)
        if 2 * off < s:          # the last step needs no decay product
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        u = u_next
        off *= 2
    h = u[:, 1:] if h0 is not None else u
    return h, h[:, -1].clone()


def rglru_step(x: Tensor, r: Tensor, i: Tensor, lam: Tensor, h: Tensor):
    """Single decode step.  x/r/i (B, W); h (B, W) -> (out, h_new)."""
    a, u = _decay_and_input(x, r, i, lam)
    h_new = a * h.to(torch.float32) + u
    return h_new, h_new


def apply_rglru_block(p: dict, x: Tensor, state: dict | None = None):
    """Full Griffin recurrent block.  x (B, S, D) -> (y (B,S,D), new_state).

    ``state``: {"h": (B,W) fp32, "conv": (B,K-1,W)} or None (training,
    zeros).  The gate's GeLU is the tanh form (``jax.nn.gelu``'s default,
    which the reference's block takes)."""
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    u = x @ p["w_in"].to(dt)
    u, conv_state = conv1d_causal(
        u, p["conv_w"], p["conv_b"], None if state is None else state["conv"])

    uf = u.to(torch.float32)
    r = torch.sigmoid(uf @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(uf @ p["w_x"].to(torch.float32) + p["b_x"])
    lam = _lambda_init(p["lam"])

    h0 = None if state is None else state["h"]
    if x.shape[1] == 1 and state is not None:             # decode fast path
        h_seq, h_last = rglru_step(u[:, 0], r[:, 0], i[:, 0], lam, h0)
        h_seq = h_seq[:, None]
    else:
        h_seq, h_last = rglru_scan(u, r, i, lam, h0)

    y = (h_seq.to(dt) * gate) @ p["w_out"].to(dt)
    return y, {"h": h_last, "conv": conv_state}


def rglru_state_zeros(b: int, width: int, conv_width: int = 4,
                      dtype=torch.float32, device="cuda") -> dict:
    dev = resolve_device(device, meta=True)
    return {"h": torch.zeros((b, width), dtype=torch.float32, device=dev),
            "conv": torch.zeros((b, conv_width - 1, width), dtype=dtype,
                                device=dev)}


def rglru_state_axes() -> dict:
    """The logical axes of :func:`rglru_state_zeros`' state."""
    return {"h": ("batch", "state"), "conv": ("batch", None, "state")}


def rglru_flops_per_token(d: int, width: int, conv_width: int = 4) -> int:
    """Matmul FLOPs/token: 3 d x W projections + 2 W x W gates + conv."""
    return 2 * (3 * d * width + 2 * width * width) + 2 * conv_width * width
