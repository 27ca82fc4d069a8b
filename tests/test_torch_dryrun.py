"""The port's dry run (launch/lowering.py, launch/dryrun.py,
launch/cost_analysis.py) against the JAX package's, with no JAX compile.

* ``arch_cells()`` and ``analytic_model_flops`` equal the reference's for
  all 40 cells.
* Every input of every runnable cell (bf16 serving params, caches,
  batch, train state) has the reference's shape and dtype (its structs,
  the caches by ``jax.eval_shape``, a ``scan_layers`` stack split into the
  port's layers), and the batch and the caches resolve to the
  reference's specs on a (4, 4) mesh (the params' are held by
  tests/test_torch_sharding.py).
* Prefill and decode outputs, run on ``meta`` tensors, have the shapes
  and dtypes of ``jax.eval_shape`` of the reference's steps.
* In one subprocess on a ``fake`` group (tests/torch_dryrun_checks.py):
  the five reduced cells of tests/test_lowering_smoke.py on a (4, 4)
  mesh count FLOPs, bytes and collective bytes, and their per-device
  argument bytes equal the sum of the reference's local shard sizes; one
  matmul split 8 ways counts an eighth of its FLOPs a device; heads that
  ``model`` divides and ``data`` does not split over ``model`` (the
  projections' and a prefill's FLOPs at that split); experts that
  ``model`` divides split over it (a rank's expert products a quarter of
  the whole layer's on a (2, 4) mesh); at world
  size 1 the reduced starcoder2-3b prefill, decode and train step count
  the same on ``meta`` as on real CPU tensors (what chip_smoke.py's
  phase 19b repeats on the card), and the sharded serving steps on a
  (1, 1) mesh give the mesh-less bits.
* The count itself: a hand-built sequence of allocations and frees gives
  its hand-counted peak; #10's ``meta`` route gives q's shape and dtype
  and the pairs ``attended`` counts, launches nothing and still raises
  under grad; the closed-form pair count equals a loop over the queries;
  the search's dispatchers and entry points still refuse ``meta``.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.dist import sharding as jshd
from repro.launch import lowering as jlowering
from repro.models.registry import build_model as jbuild_model
from repro.train import train_loop as jtrain_loop

from repro_torch import configs as tconfigs
from repro_torch.configs import common as tcommon
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.launch import lowering
from repro_torch.launch.cost_analysis import CostCount
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model
from repro_torch.train import train_loop
from repro_torch.train.checkpoint import _flatten_with_names

REPO = Path(__file__).resolve().parents[1]
SIZES = {"data": 4, "model": 4}
JMESH = Mesh(np.array(jax.devices() * 16)[:16].reshape(4, 4),
             ("data", "model"))
SEQ, BATCH = 64, 8           # tests/torch_dryrun_checks.py's cells
CELLS = [("starcoder2-3b", "train"), ("rwkv6-1.6b", "train"),
         ("qwen3-moe-30b-a3b", "train"), ("recurrentgemma-2b", "decode"),
         ("whisper-tiny", "prefill")]
COUNTS = ("flops_per_device", "bytes_per_device",
          "collective_bytes_per_device", "transcendentals_per_device")


@pytest.fixture(scope="module", autouse=True)
def spawned():
    """tests/torch_dryrun_checks.py, started before the module's first
    test (so the in-process tests run beside it) and read when a test
    needs its results."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dryrun_checks.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def result() -> dict:
        if "out" not in box:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            box["out"] = json.loads(out.strip().splitlines()[-1])
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# Trees: the reference's leaves under the port's names
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) for e in x)


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_axes(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)[0]}


def _unstack(leaves: dict, axes: dict, stack: str, layers: int):
    """A reference tree's leaves and axes under the port's names: a leaf
    on a ``layers`` axis (a ``scan_layers`` stack, its names after
    ``stack``) split into one leaf a layer without it."""
    out, out_axes = {}, {}
    for name, s in leaves.items():
        ax = tuple(axes[name])
        if ax and ax[0] == "layers":
            assert name.startswith(stack), name
            for i in range(layers):
                key = f"{stack}[{i}]" + name[len(stack):]
                out[key] = jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
                out_axes[key] = ax[1:]
        else:
            out[name], out_axes[name] = s, ax
    return out, out_axes


def _port_leaves(tree) -> dict:
    return {n: t for n, t in _flatten_with_names(tree).items()
            if t is not None}


def _port_axes(tree, prefix: str = "") -> dict:
    """name -> logical axes of a tree of axes tuples (dicts, lists,
    NamedTuples; None: no tensor)."""
    if tree is None:
        return {}
    if _is_axes(tree):
        return {prefix: tree}
    if hasattr(tree, "_fields"):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree,
                                              strict=True)]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", v) for k, v in tree.items()]
    else:
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    out = {}
    for key, v in items:
        out.update(_port_axes(v, prefix + key))
    return out


def _same_structs(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:6])
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), (what, name)
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), (
            what, name)


def _jspec(names, shape, rules) -> tuple:
    spec = tuple(jshd.spec_for_shape(tuple(names), tuple(shape), JMESH,
                                     rules))
    return spec + (None,) * (len(shape) - len(spec))


def _layers(cfg) -> int:
    return getattr(cfg, "num_layers", 0)


def _ref_cache(ref, jshape, layers: int):
    return _unstack(_ref_leaves(jlowering.cache_structs_for(ref, jshape)),
                    _ref_axes(ref.cache_axes()), "", layers)


# ---------------------------------------------------------------------------
# The cell grid and the model FLOPs
# ---------------------------------------------------------------------------

def test_arch_cells_are_the_reference_s():
    assert tconfigs.arch_cells() == jconfigs.arch_cells()
    assert len(tconfigs.arch_cells()) == 40
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.arch_shapes(arch) == jconfigs.arch_shapes(arch)
        assert tconfigs.arch_family(arch) == jconfigs.arch_family(arch)


def test_analytic_model_flops_are_the_reference_s():
    for arch, shape, _ok, _note in tconfigs.arch_cells():
        assert lowering.analytic_model_flops(arch, shape) == \
            jlowering.analytic_model_flops(arch, shape), (arch, shape)


# ---------------------------------------------------------------------------
# Inputs: shapes, dtypes and specs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_inputs_are_the_reference_s(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    port, ref = build_model(cfg, device="meta"), jbuild_model(jcfg)
    layers = _layers(cfg)
    p_axes = _ref_axes(ref.param_axes())

    def ref_params(tree):
        return _unstack(_ref_leaves(tree), p_axes, "['layers']", layers)[0]

    _same_structs(_port_leaves(lowering.serve_param_structs(port)),
                  ref_params(jlowering.serve_param_structs(ref)), "params")
    got, want = train_loop.state_structs(port), jtrain_loop._state_structs(
        ref)
    for part in ("mu", "nu"):
        _same_structs(_port_leaves(getattr(got.opt, part)),
                      ref_params(getattr(want.opt, part)), part)
    _same_structs(_port_leaves(got.params), ref_params(want.params),
                  "state params")
    assert got.opt.step.shape == () and got.opt.step.dtype == torch.int32
    assert str(want.opt.step.dtype) == "int32"
    for shape_name in tconfigs.arch_shapes(arch):
        shape, jshape = (tcommon.SHAPES[shape_name],
                         jcommon.SHAPES[shape_name])
        rules = None if shape.kind == "train" else shd.SERVE_RULES
        batch = tcommon.batch_structs(port, shape)
        want_b = jcommon.batch_structs(ref, jshape)
        _same_structs(batch, want_b, f"batch {shape_name}")
        axes, jaxes = (tcommon.batch_axes(port, shape),
                       jcommon.batch_axes(ref, jshape))
        for k, t in batch.items():
            assert shd.spec_for_shape(axes[k], t.shape, SIZES, rules) == \
                _jspec(jaxes[k], t.shape, rules), (shape_name, k)
        if shape.kind == "train":
            continue
        want_c, want_axes = _ref_cache(ref, jshape, layers)
        caches = _port_leaves(lowering.cache_structs_for(port, shape))
        _same_structs(caches, want_c, f"caches {shape_name}")
        got_axes = _port_axes(port.cache_axes())
        for name, t in caches.items():
            assert t.device.type == "meta"
            assert shd.spec_for_shape(got_axes[name], t.shape, SIZES,
                                      rules) == _jspec(
                want_axes[name], t.shape, rules), (shape_name, name)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_serving_outputs_have_the_reference_s_shapes(arch):
    """The reduced config's prefill and decode step on ``meta`` (no mesh)
    against ``jax.eval_shape`` of the reference's."""
    cfg, jcfg = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    port, ref = build_model(cfg, device="meta"), jbuild_model(jcfg)
    seq = max(SEQ, 2 * getattr(cfg, "num_patch_tokens", 0))
    for kind in ("prefill", "decode"):
        shape = tcommon.ShapeSpec("x", seq, 2, kind)
        jshape = jcommon.ShapeSpec("x", seq, 2, kind)
        params = lowering.serve_param_structs(port)
        batch = tcommon.batch_structs(port, shape)
        caches = lowering.cache_structs_for(port, shape)
        jparams = jlowering.serve_param_structs(ref)
        jbatch = jcommon.batch_structs(ref, jshape)
        jcaches = jlowering.cache_structs_for(ref, jshape)
        if kind == "prefill":
            lengths = batch.pop("lengths")
            jlengths = jbatch.pop("lengths")
            hidden, out = port.prefill(params, batch, caches, lengths)
            jhidden, jout = jax.eval_shape(ref.prefill, jparams, jbatch,
                                           jcaches, jlengths)
            got, want = {"hidden": hidden}, {"hidden": jhidden}
        else:
            logits, hidden, out = port.decode_step(
                params, batch["tokens"], batch["positions"], caches,
                batch["lengths"])
            jlogits, jhidden, jout = jax.eval_shape(
                ref.decode_step, jparams, jbatch["tokens"],
                jbatch["positions"], jcaches, jbatch["lengths"])
            got = {"logits": logits, "hidden": hidden}
            want = {"logits": jlogits, "hidden": jhidden}
        _same_structs(got, want, kind)
        want_c, _ = _unstack(_ref_leaves(jout), _ref_axes(ref.cache_axes()),
                             "", _layers(cfg))
        _same_structs(_port_leaves(out), want_c, f"{kind} caches")


# ---------------------------------------------------------------------------
# The fake-group subprocess
# ---------------------------------------------------------------------------

def _reference_argument_bytes(arch: str, kind: str) -> int:
    """The sum of the reference's local shard sizes of one reduced cell's
    inputs on a (4, 4) mesh (its own structs, axes and specs)."""
    jcfg = jconfigs.get_reduced(arch)
    ref = jbuild_model(jcfg)
    jshape = jcommon.ShapeSpec("x", SEQ, BATCH, kind)
    rules = None if kind == "train" else jshd.SERVE_RULES
    trees = []           # (structs, axes) pairs
    p_axes = ref.param_axes()
    if kind == "train":
        state = jtrain_loop._state_structs(ref)
        trees += [(state.params, p_axes), (state.opt.mu, p_axes),
                  (state.opt.nu, p_axes), (state.opt.step, None)]
    else:
        trees.append((jlowering.serve_param_structs(ref), p_axes))
        trees.append((jlowering.cache_structs_for(ref, jshape),
                      ref.cache_axes()))
    batch = jcommon.batch_structs(ref, jshape)
    axes = jcommon.batch_axes(ref, jshape)
    # lengths are replicated (the reference's P())
    trees += [(batch[k], None if k == "lengths" else axes[k])
              for k in batch]
    total = 0
    for structs, ax in trees:
        leaves = _ref_leaves(structs)
        names = {n: None for n in leaves} if ax is None else _ref_axes(ax)
        for name, s in leaves.items():
            spec = (() if names[name] is None
                    else _jspec(names[name], s.shape, rules))
            n = math.prod(s.shape) * np.dtype(s.dtype).itemsize
            for entry in spec:
                for mesh_ax in ((entry,) if isinstance(entry, str)
                                else entry or ()):
                    n //= SIZES[mesh_ax]
            total += n
    return total


@pytest.mark.parametrize("arch,kind", CELLS)
def test_reduced_cells_count_on_a_fake_mesh(spawned, arch, kind):
    rec = spawned()["cells"][f"{arch}/{kind}"]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "peak_bytes"):
        assert rec[key] > 0, key
    assert rec["argument_bytes"] == _reference_argument_bytes(arch, kind)


def test_a_split_matmul_counts_its_local_share(spawned):
    rec = spawned()["matmul"]
    assert rec["local_shape"] == [32, 8]
    assert rec["flops"] * 8 == rec["whole_flops"] == 2 * 64 * 48 * 32
    assert rec["bytes"] == 4 * (32 * 48 + 48 * 8 + 32 * 8)
    assert rec["collective_bytes"] == 0


def test_heads_split_over_model_where_data_does_not_divide_them(spawned):
    """6 query heads over 2 kv heads on a (4, 2) mesh: each rank projects
    its 2 rows' 3 query heads and 1 kv head, and its share of the MLP;
    the reduced starcoder2-3b prefill counts exactly its matmuls at that
    split plus #10's pairs (elementwise arithmetic counts no FLOPs)."""
    rec = spawned()["heads"]
    cfg = tconfigs.get_reduced("starcoder2-3b")
    d, k, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    rows = (BATCH // 4) * SEQ                  # one data rank's tokens
    h, kh = 6 // 2, 2 // 2                     # one model rank's heads
    q_and_o = 2 * (2 * rows * d * h * k)
    assert rec["projections_serve"] == rec["projections_train"] == q_and_o
    pairs = tflash.attended(SEQ, SEQ, True, None)[0]
    layer = (q_and_o + 2 * (2 * rows * d * kh * k)
             + 4 * (BATCH // 4) * h * pairs * k
             + 2 * (2 * rows * d * (f // 2)))
    assert rec["prefill"] == cfg.num_layers * layer


def test_experts_split_over_model_count_their_share(spawned):
    """The reduced qwen3-moe-30b-a3b MoE layer on a (2, 4) mesh: a rank's
    expert products (three ``bmm``s over its E/4 experts' slots) count a
    quarter of the whole layer's on one data rank's rows; the router's
    product and the combine (each token's K outputs) stay whole; the
    stacks reach their experts by an all-to-all and the partial outputs
    are summed by an all-reduce."""
    rec = spawned()["experts"]
    cfg = tconfigs.get_reduced("qwen3-moe-30b-a3b")
    d, f = cfg.d_model, cfg.moe_d_ff
    e, k, sp = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.group_tokens
    tokens = (BATCH // 2) * SEQ                # one data rank's
    slots = (tokens // sp) * tmoe._capacity(cfg.moe, sp)
    products = 3 * (2 * e * slots * d * f)     # every expert's
    combine = 2 * tokens * k * d
    assert rec["whole_flops_by_op"]["bmm"] == products + combine
    assert rec["flops_by_op"]["bmm"] == products // 4 + combine
    assert rec["flops_by_op"]["mm"] == rec["whole_flops_by_op"]["mm"] \
        == 2 * tokens * d * e
    assert {"all-to-all", "all-reduce"} <= set(rec["collectives"])


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_counts_equal_the_cpu_s_at_world_size_one(spawned, kind):
    rec = spawned()["world1"][kind]
    meta, cpu = rec["meta"], rec["cpu"]
    for key in (*COUNTS, "argument_bytes", "output_bytes", "alias_bytes"):
        assert meta[key] == cpu[key], key
    assert meta["flops_per_device"] > 0
    if kind == "prefill":
        # the CPU runs #10's plain version, whose logits the kernel never
        # makes: its peak only is higher
        assert cpu["peak_bytes_est"] >= meta["peak_bytes_est"]
    else:
        assert cpu["peak_bytes_est"] == meta["peak_bytes_est"]


def test_sharded_serving_at_world_size_one_is_bit_equal(spawned):
    assert spawned()["serving1"] == {"hidden_equal": True,
                                     "tokens_equal": True,
                                     "caches_equal": True}


# ---------------------------------------------------------------------------
# The count itself
# ---------------------------------------------------------------------------

def test_peak_of_a_hand_built_sequence():
    def alloc(n_floats):
        return torch.empty(n_floats, device="meta")

    arg = alloc(100)                       # 400 B, live from the start
    count = CostCount()
    assert count.add_arguments([arg]) == 400
    with count:
        a = alloc(250)                     # 1000 -> live 1400
        b = alloc(500)                     # 2000 -> live 3400
        view = b[10:]                      # a view: no storage
        b.add_(1.0)                        # in place: no storage
        del a                              # live 2400
        c = alloc(125)                     # 500  -> live 2900
        d = torch.cat([view, view])        # 3920 -> live 6820
        del d, view, b                     # live 900
        e = alloc(1000)                    # 4000 -> live 4900
    assert count.peak_bytes == 6820
    assert count.live_bytes == 400 + 500 + 4000
    del c, e
    assert count.live_bytes == 400


def test_flash_attention_on_meta_counts_pairs_and_launches_nothing():
    b, h, kh, sq, skv, d = 2, 8, 2, 40, 96, 64
    q = torch.empty(b, sq, h, d, dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)
    k = torch.empty(b, skv, kh, d, dtype=torch.bfloat16,
                    device="meta").transpose(1, 2)
    before = tflash.launches
    count = CostCount()
    with count:
        out = ops.flash_attention(q, k, k, causal=True, window=32)
    assert tflash.launches == before
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta" and out.stride() == q.stride()
    pairs = tflash.attended(sq, skv, True, 32)[0]
    assert count.flops == 4 * d * b * h * pairs
    assert count.transcendentals == b * h * pairs
    assert count.bytes == 2 * (2 * q.numel() + 2 * k.numel())
    g = torch.empty(1, 2, 8, 16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no backward pass"):
        ops.flash_attention(g, g, g)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(torch.empty(1, 2, 8, 24, device="meta"),
                            torch.empty(1, 2, 8, 24, device="meta"),
                            torch.empty(1, 2, 8, 24, device="meta"))


def _attended_loop(sq, skv, causal, window):
    pairs, first = 0, skv
    for i in range(sq):
        pos = i + skv - sq
        hi = min(pos + 1, skv) if causal else skv
        lo = max(0, pos - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            first = min(first, lo)
    return pairs, skv - first


def test_attended_closed_form_is_the_loop():
    for sq in range(1, 12):
        for skv in range(1, 12):
            for causal in (True, False):
                for window in (None, 1, 2, 3, 5, 16):
                    assert tflash.attended(sq, skv, causal, window) == \
                        _attended_loop(sq, skv, causal, window)
    assert tflash.attended(32768, 32768, True, None) == (
        32768 * 32769 // 2, 32768)


def test_meta_is_asked_for_explicitly_and_no_search_kernel_takes_it():
    assert resolve_device("meta", meta=True).type == "meta"
    with pytest.raises(ValueError, match="cuda or cpu device"):
        resolve_device("meta")
    t = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.bregman_ub_matrix(t, t, torch.empty(2, 4, device="meta"),
                              torch.empty(2, 4, device="meta"))
    assert build_model(tconfigs.get_reduced("starcoder2-3b"),
                       device="meta").device.type == "meta"
