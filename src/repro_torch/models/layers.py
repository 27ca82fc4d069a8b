"""Norms, embeddings, RoPE and MLPs (port of ``repro.models.layers``).

Parameters are plain dicts of tensors.  Every layer computes in its input's
dtype and keeps the reference's places of fp32 arithmetic: the norms
reduce in fp32 and cast back, the logits come out in fp32.

A :class:`Spec` declares one parameter: its shape, its logical axes
(``embed``, ``heads``, ``kv_heads``, ``head_dim``, ``mlp``, ``vocab``,
``experts``, ``expert_mlp``, ``state`` and the fsdp weight axis ``fsdp``,
resolved by ``dist/sharding.py``) and its init.  The models' spec trees
give ``param_axes`` and ``param_structs`` (``meta`` tensors) beside the
parameters ``init_params`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import constrain, row_matmul, span

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_normal(shape: tuple, generator: torch.Generator,
                scale: float | None = None) -> Tensor:
    """N(0, 1) x ``scale`` on the generator's device; ``scale`` defaults to
    1/sqrt(shape[0]), the reference ``Spec``'s fan-in rule."""
    if scale is None:
        scale = 1.0 / max(shape[0] if shape else 1, 1) ** 0.5
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter: shape, logical axes (one per dim, None: never
    sharded), init ("normal", "zeros", "ones" or another name the
    reference gives a normal draw) and the normal's scale (None: the
    fan-in rule)."""
    shape: tuple
    axes: tuple
    init: str = "normal"
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def init_spec(spec: dict, generator: torch.Generator) -> dict:
    """Parameters of a spec dict (name -> :class:`Spec`), drawn in the
    dict's order on the generator's device: "zeros", "ones", and any other
    init normal x ``scale`` (None: the fan-in rule).  The reference's
    ``Spec.materialize`` treats every init but zeros and ones as a normal
    draw, its "uniform_lambda" included."""
    dev = generator.device
    out = {}
    for name, s in spec.items():
        if s.init == "zeros":
            out[name] = torch.zeros(s.shape, device=dev)
        elif s.init == "ones":
            out[name] = torch.ones(s.shape, device=dev)
        else:
            out[name] = init_normal(s.shape, generator, s.scale)
    return out


def _spec_map(fn, tree):
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return [_spec_map(fn, v) for v in tree]


def spec_size(specs) -> int:
    """Parameters in a tree of dicts and lists of :class:`Spec`."""
    if isinstance(specs, Spec):
        n = 1
        for d in specs.shape:
            n *= d
        return n
    values = specs.values() if isinstance(specs, dict) else specs
    return sum(spec_size(v) for v in values)


def axes_tree(specs):
    """The logical axes of each :class:`Spec` of a tree of dicts and
    lists."""
    return _spec_map(lambda s: s.axes, specs)


def struct_tree(specs):
    """Each :class:`Spec` of a tree as an fp32 tensor on the ``meta``
    device (its shape and dtype; nothing is allocated)."""
    return _spec_map(lambda s: torch.empty(s.shape, device="meta"), specs)


def norm_spec(d: int, kind: str) -> dict:
    """The norm parameters :func:`init_norm` makes."""
    p = {"scale": Spec((d,), ("embed",), "ones")}
    if kind != "rmsnorm":
        p["bias"] = Spec((d,), ("embed",), "zeros")
    return p


def embed_spec(vocab: int, d: int) -> Spec:
    """A (padded vocab, d) embedding or unembedding table."""
    return Spec((padded_vocab(vocab), d), ("vocab", "fsdp"), scale=1.0)


def mlp_spec(d: int, f: int, gated: bool, bias: bool) -> dict:
    """The MLP parameters :func:`init_mlp` makes."""
    p = {"w_in": Spec((d, f), ("fsdp", "mlp")),
         "w_out": Spec((f, d), ("mlp", "fsdp"))}
    if gated:
        p["w_gate"] = Spec((d, f), ("fsdp", "mlp"))
    if bias:
        p["b_in"] = Spec((f,), ("mlp",), "zeros")
        p["b_out"] = Spec((d,), ("embed",), "zeros")
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm in fp32 (returns x.dtype)."""
    xf = x.to(torch.float32)
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm in fp32 (returns x.dtype)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    nrm = (xf - mu) * torch.rsqrt(var + eps)
    return (nrm * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def apply_norm(p: dict, x: Tensor, kind: str) -> Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def padded_vocab(vocab: int, multiple: int = 128) -> int:
    """Vocab tables are padded to a multiple of 128 rows; the pad logits
    are stripped at the sampling boundary (``transformer.logits_fn``)."""
    return -(-vocab // multiple) * multiple


def embed_lookup(table: Tensor, tokens: Tensor, compute_dtype) -> Tensor:
    """Rows of the table for (B, S) tokens, in ``compute_dtype``.  The
    reference multiplies a one-hot matrix by the table cast to that dtype,
    which selects the same values this gather does.  ``F.embedding``'s
    backward adds each row's gradients in a fixed order on both devices
    (an indexing gather's backward adds with atomics on a multi-threaded
    CPU), so two training runs give the same bits."""
    # under a mesh: the fsdp shards gathered for the lookup (reference
    # layers.py:153)
    table = constrain(table, ("vocab", None))
    if isinstance(table, DTensor) and Shard(0) in table.placements:
        return _sharded_lookup(table, tokens).to(compute_dtype)
    return F.embedding(tokens.long(), table).to(compute_dtype)


def _sharded_lookup(table: DTensor, tokens: DTensor) -> DTensor:
    """``F.embedding`` from a vocab-sharded table as the reference's
    one-hot product makes it: each rank looks up the tokens that fall in
    its rows (the rest zero) and the partial sums are added over the
    vocab's ranks; the same values, where DTensor's own lookup leaves a
    masked partial that torch 2.11 cannot compare on ``meta``.  The
    table's gradient from a rank's token rows is partial over the mesh
    dims that split those rows."""
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    rows = tuple(p if p == Shard(0) else Replicate()
                 for p in tokens.placements)
    if tuple(tokens.placements) != rows:
        tokens = tokens.redistribute(mesh, rows)
    local = table.to_local(grad_placements=tuple(
        p if i in vocab else Partial() if r == Shard(0) else p
        for i, (p, r) in enumerate(zip(table.placements, rows,
                                       strict=True))))
    ids = tokens.to_local().long() - span(table, 0).start
    inside = (ids >= 0) & (ids < local.shape[0])
    got = F.embedding(torch.where(inside, ids, 0), local) * inside[
        ..., None].to(local.dtype)
    part = tuple(Partial() if i in vocab else p
                 for i, p in enumerate(rows))
    return DTensor.from_local(got, mesh, part,
                              run_check=False).redistribute(mesh, rows)


def unembed_logits(x: Tensor, table: Tensor) -> Tensor:
    """(..., d) @ (V, d)^T -> (..., V) fp32 logits: the table is cast to
    x's dtype, then both operands are widened so the product accumulates
    and stays in fp32 (the reference's ``preferred_element_type``)."""
    table = constrain(table.to(x.dtype), ("vocab", None))
    return row_matmul(x.to(torch.float32), table.to(torch.float32).T)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    """(head_dim//2,) inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4,
               mrope_section: tuple[int, ...] | None = None) -> Tensor:
    """Rotary embedding, half-split (not interleaved), optionally
    multimodal (M-RoPE, Qwen2-VL §3.1).  x (B, S, H, D); positions (B, S)
    int, or (B, S, 3) for M-RoPE (temporal, height, width components; a
    (B, S, 3) tensor under plain RoPE takes component 0).  M-RoPE splits
    the D/2 frequency channels into three sections, section ``i`` rotating
    by positions[..., i]; (B, S) positions give every section the same
    component, so M-RoPE on text equals 1-D RoPE bit for bit.  sin and cos
    are cast to x's dtype before they multiply, as in the reference."""
    b, s, _, d = x.shape
    half = d // 2
    inv = rope_frequencies(d, theta, x.device)                    # (half,)
    if mrope_section is not None:
        if sum(mrope_section) != half:
            raise ValueError(f"mrope_section {mrope_section} must sum to "
                             f"half the head dim, {half}")
        if positions.ndim == 2:
            positions = positions[..., None].expand(b, s, 3)
        comp = torch.repeat_interleave(
            torch.arange(3, device=x.device),
            torch.as_tensor(mrope_section, device=x.device),
            output_size=half)                                    # (half,)
        pos = positions.to(torch.float32)[..., comp]             # (B,S,half)
    else:
        if positions.ndim == 3:
            positions = positions[..., 0]
        pos = positions.to(torch.float32)[..., None]             # (B,S,1)
    angle = pos * inv                                            # (B,S,half)
    sin = torch.sin(angle)[:, :, None, :].to(x.dtype)
    cos = torch.cos(angle)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(seq: int, d: int, device=None) -> Tensor:
    """Whisper's fixed sinusoid table (seq, d) in fp32: sin then cos of
    position x 10000^(-i / max(d/2 - 1, 1)), the reference's exponent."""
    half = d // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / max(half - 1, 1)))
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(d: int, f: int, gated: bool, bias: bool,
             generator: torch.Generator) -> dict:
    return init_spec(mlp_spec(d, f, gated, bias), generator)


def _act(name: str) -> Callable[[Tensor], Tensor]:
    # The reference's "gelu" is jax.nn.gelu, whose default is the tanh
    # approximation.
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu_sq": lambda x: torch.square(F.relu(x))}[name]


def apply_mlp(p: dict, x: Tensor, act: str) -> Tensor:
    """Gated (SwiGLU/GeGLU) or plain 2-layer MLP; matmuls in x.dtype."""
    dt = x.dtype
    h = row_matmul(x, p["w_in"].to(dt))
    if "b_in" in p:
        h = h + p["b_in"].to(dt)
    h = _act(act)(h)
    if "w_gate" in p:
        h = h * row_matmul(x, p["w_gate"].to(dt))
    out = row_matmul(h, p["w_out"].to(dt))
    if "b_out" in p:
        out = out + p["b_out"].to(dt)
    return out
