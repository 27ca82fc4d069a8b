"""The port's sharded training and dist/ substrates at world sizes 2 and 4
over gloo, against the JAX package on forced host meshes of as many
devices.

Run as a script (tests/test_torch_dist_train.py does, in a subprocess):

    PYTHONPATH=src python tests/torch_dist_train_checks.py --worlds 2 4

For each world size it spawns that many ranks joined over gloo at a free
localhost port; the worlds run side by side, beside one JAX child (forced
host devices) that writes its results to an npz per world.  Each rank
checks:

* ``ag_matmul`` equals ``ag_matmul_reference`` and both lie within 1e-6
  relative of the whole ``x @ w``; ``matmul_rs`` gives each rank its rows
  of ``x @ w`` within 1e-6 relative, and raises ``ValueError`` on rows
  the axis does not divide;
* int8 compression: the codes, scales and residuals of six calls (one,
  then five with error feedback) bit-equal to the JAX side's, the mean
  within 1e-6 of the JAX side's largest |mean|, and the reference's own
  checks (tests/dist_checks.py): one-shot error under 0.05, the mean
  applied over the five error-feedback steps no further from the true
  mean than that, residuals under 0.1; the tree form equal to the leaf
  form;
* ``pipeline_apply`` with p = world stages equal bit for bit to applying
  the stages in turn, and within 1e-6 of the JAX side's;
* the sharded train step (1 step, 2 microbatches, fp32): starcoder2-3b
  reduced on ("data",) at world 2 and on 2 x 2 ("data", "model") at world
  4, qwen3-moe-30b-a3b reduced on 2 x 2: the state within
  ``repro_torch.train.compare``'s limits of the port's single-process
  step and of the reference's ``make_train_step`` on a forced host mesh
  of the same shape, from the reference's initial parameters; every
  parameter's and moment's local shard of the shape ``spec_for_shape``
  resolves;
* elastic restore: world 4 saves its starcoder2 state after the step,
  world 2 restores it onto its ("data",) mesh: bit-equal to the saved
  global arrays, and its next step within the compare limits of the
  single-process step from them.

Beside the worlds: ``launch/train.py`` under ``torchrun`` on two ranks,
resuming the one-device launcher's checkpoint onto a ("data",) mesh of
two (:func:`check_launcher`).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEQ, BATCH, MICRO = 32, 4, 2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
GRAD_TOL = 1e-4          # of a leaf's largest gradient (the parity tests')
# case -> (arch, mesh shape, mesh axes); the world is the mesh's size
TRAIN_CASES = {
    "dense_data": ("starcoder2-3b", (2,), ("data",)),
    "dense_2x2": ("starcoder2-3b", (2, 2), ("data", "model")),
    "moe_2x2": ("qwen3-moe-30b-a3b", (2, 2), ("data", "model")),
}
ELASTIC = "dense_2x2"    # saved at world 4, restored at world 2
N_MICRO_PIPE, PIPE_DIM = 6, 16


def cases_of(world: int) -> list:
    return [c for c, (_, shape, _) in TRAIN_CASES.items()
            if int(np.prod(shape)) == world]


# ---------------------------------------------------------------------------
# Inputs, the same on every rank and in the JAX child
# ---------------------------------------------------------------------------

def matmul_inputs(p: int):
    rng = np.random.default_rng(10 + p)
    x = rng.normal(size=(3 * p, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    xk = rng.normal(size=(4 * p, 4 * p)).astype(np.float32)
    wk = rng.normal(size=(4 * p, 6)).astype(np.float32)
    return x, w, xk, wk


def grads_input(p: int) -> np.ndarray:
    return np.random.default_rng(20 + p).normal(
        size=(p, 128)).astype(np.float32)


def pipe_inputs(p: int):
    rng = np.random.default_rng(30 + p)
    ws = (rng.normal(size=(p, PIPE_DIM, PIPE_DIM)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(N_MICRO_PIPE, 8, PIPE_DIM)).astype(np.float32)
    return ws, xs


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def jax_side(out: str, worlds) -> None:
    """For each world size, the JAX package's compression, pipeline and
    train steps on a mesh of that many forced host devices, written to
    ``<out>/jax_<world>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.configs.common import ShapeSpec
    from repro.data import pipeline as jdata
    from repro.dist.compression import _quantize_int8, compressed_psum_mean
    from repro.dist.pipeline import pipeline_apply
    from repro.dist.sharding import make_mesh
    from repro.models.registry import build_model
    from repro.train import optimizer as jopt
    from repro.train import train_loop as jloop

    # Two passes, the largest world first: the initial states (the ranks
    # start their own steps from them), then everything else.
    order = sorted(worlds, reverse=True)
    meshes, states = {}, {}
    for world in order:
        arrays = {}
        devs = jax.devices()[:world]
        for case in cases_of(world):
            arch, shape, axes = TRAIN_CASES[case]
            cfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                      compute_dtype=jnp.float32)
            bundle = build_model(cfg)
            tmesh = make_mesh(shape, axes, devices=devs)
            with tmesh:
                state = jloop.init_train_state(bundle, tmesh,
                                               jax.random.PRNGKey(0))
            meshes[case], states[case] = (bundle, tmesh), state
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                arrays[f"{case}/before/{jax.tree_util.keystr(path)}"] = \
                    np.array(leaf)
        _write(out, f"jax_init_{world}", arrays)

    for world in order:
        arrays = {}
        devs = jax.devices()[:world]
        mesh = make_mesh((world,), ("data",), devices=devs)

        def body(gl, res):
            code, scale = _quantize_int8(gl + res)
            mean, new_res = compressed_psum_mean(gl, "data", res)
            return code, scale[None], mean, new_res

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data"), P("data"), P("data"))))
        g = jnp.asarray(grads_input(world))
        res = jnp.zeros_like(g)
        for t in range(6):
            code, scale, mean, res = fn(g, res)
            for name, v in (("code", code), ("scale", scale),
                            ("mean", mean), ("residual", res)):
                arrays[f"ef/{t}/{name}"] = np.asarray(v)

        ws, xs = pipe_inputs(world)
        pmesh = make_mesh((world,), ("stage",), devices=devs)
        arrays["pipe"] = np.asarray(pipeline_apply(
            lambda w, x: jnp.tanh(x @ w), pmesh, "stage", jnp.asarray(ws),
            jnp.asarray(xs)))

        for case in cases_of(world):
            bundle, tmesh = meshes[case]
            sshape = ShapeSpec("smoke", seq_len=SEQ, global_batch=BATCH,
                               kind="train")
            tc = jloop.TrainConfig(microbatches=MICRO,
                                   opt=jopt.OptimizerConfig(**OPT))
            stream = jdata.TokenStreamConfig(
                vocab_size=bundle.cfg.vocab_size, seq_len=SEQ,
                global_batch=BATCH)
            with tmesh:
                step = jloop.make_train_step(bundle, tmesh, tc, sshape)
                batch = jax.device_put(
                    jdata.token_batch(stream, 0, tmesh),
                    jloop.batch_shardings(bundle, sshape, tmesh))
                state, m = step(states.pop(case), batch)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                arrays[f"{case}/after/{jax.tree_util.keystr(path)}"] = \
                    np.array(leaf)
            arrays[f"{case}/lr"] = np.asarray(m["lr"])
        _write(out, f"jax_{world}", arrays)


def _write(out: str, name: str, arrays: dict) -> None:
    tmp = os.path.join(out, f"{name}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(out, f"{name}.npz"))


def load_jax(out: str, name: str, wait_s: float = 300.0) -> dict:
    """The JAX child's npz ``name``, once written."""
    path = os.path.join(out, f"{name}.npz")
    failed = os.path.join(out, "jax.failed")
    end = time.monotonic() + wait_s
    while not os.path.exists(path):
        if os.path.exists(failed) or time.monotonic() > end:
            raise RuntimeError(f"the JAX side wrote no {path}")
        time.sleep(0.1)
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# The port's side, on each rank
# ---------------------------------------------------------------------------

def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def check_matmuls(rank: int, world: int) -> None:
    from repro_torch.dist.collective_matmul import (ag_matmul,
                                                    ag_matmul_reference,
                                                    matmul_rs)
    from repro_torch.dist.sharding import make_mesh
    mesh = make_mesh((world,), ("model",), device="cpu")
    x, w, xk, wk = (torch.from_numpy(a) for a in matmul_inputs(world))
    rows = x.shape[0] // world
    x_local = x[rank * rows:(rank + 1) * rows]
    ring = ag_matmul(x_local, w, mesh, "model")
    bulk = ag_matmul_reference(x_local, w, mesh, "model")
    full = x @ w
    assert torch.equal(ring, bulk), _rel(ring, bulk)
    assert _rel(ring, full) <= 1e-6 and _rel(bulk, full) <= 1e-6
    k = xk.shape[1] // world
    cols = slice(rank * k, (rank + 1) * k)
    got = matmul_rs(xk[:, cols], wk[cols], mesh, "model")
    m = xk.shape[0] // world
    assert _rel(got, (xk @ wk)[rank * m:(rank + 1) * m]) <= 1e-6
    try:
        matmul_rs(xk[1:, cols], wk[cols], mesh, "model")
    except ValueError:
        pass
    else:
        raise AssertionError("matmul_rs took rows the axis does not divide")


def check_compression(rank: int, world: int, jx: dict) -> None:
    from repro_torch.dist.compression import (EFState, _quantize_int8,
                                              compressed_grad_allreduce,
                                              compressed_psum_mean,
                                              init_ef_state)
    from repro_torch.dist.sharding import make_mesh
    mesh = make_mesh((world,), ("data",), device="cpu")
    g_all = torch.from_numpy(grads_input(world))
    g = g_all[rank:rank + 1]
    true_mean = g_all.mean(dim=0, keepdim=True)
    res = torch.zeros_like(g)
    tree_ef = init_ef_state({"a": g, "b": [g * 2]})
    applied = torch.zeros_like(true_mean)
    for t in range(6):
        code, scale = _quantize_int8(g + res)
        mean, res = compressed_psum_mean(g, mesh, "data", res)
        for name, got in (("code", code), ("scale", scale.reshape(1)),
                          ("residual", res)):
            want = jx[f"ef/{t}/{name}"][rank:rank + 1].reshape(got.shape)
            assert np.array_equal(got.numpy(), want), (t, name)
        # the same sum in another order: within 1e-6 of the mean's scale
        jmean = jx[f"ef/{t}/mean"][rank:rank + 1]
        assert float(np.abs(mean.numpy() - jmean).max()) <= 1e-6 * float(
            np.abs(jmean).max()), (t, "mean")
        means, tree_ef = compressed_grad_allreduce(
            {"a": g, "b": [g * 2]}, mesh, "data", tree_ef)
        assert isinstance(tree_ef, EFState)
        assert torch.equal(means["a"], mean), t
        assert torch.equal(tree_ef.residual["a"], res), t
        if t == 0:
            err0 = float((mean - true_mean).abs().max())
            assert err0 < 0.05, err0
        else:
            applied = applied + mean
    drift = float((applied / 5 - true_mean).abs().max())
    assert drift < err0 + 1e-6, (drift, err0)
    assert float(res.abs().max()) < 0.1


def check_pipeline(rank: int, world: int, jx: dict) -> None:
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.dist.sharding import make_mesh
    mesh = make_mesh((world,), ("stage",), device="cpu")
    ws, xs = (torch.from_numpy(a) for a in pipe_inputs(world))

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    got = pipeline_apply(stage_fn, mesh, "stage", ws[rank:rank + 1], xs)
    want = torch.empty_like(xs)
    for i in range(xs.shape[0]):
        y = xs[i]
        for s in range(world):
            y = stage_fn(ws[s], y)
        want[i] = y
    assert torch.equal(got, want), float((got - want).abs().max())
    assert float(np.abs(got.numpy() - jx["pipe"]).max()) <= 1e-6


def _setup_config(arch: str):
    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tl
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    tc = tl.TrainConfig(microbatches=MICRO, opt=topt.OptimizerConfig(**OPT))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    sshape = ShapeSpec("smoke", seq_len=SEQ, global_batch=BATCH,
                       kind="train")
    return cfg, tc, stream, sshape


def _setup(arch: str, shape, axes):
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models.registry import build_model
    cfg, tc, stream, sshape = _setup_config(arch)
    bundle = build_model(cfg, device="cpu")
    mesh = make_mesh(shape, axes, device="cpu")
    return cfg, bundle, mesh, tc, stream, sshape


def _reference_tree(jx: dict, case: str, tag: str, like):
    """The JAX side's state ``tag`` of ``case`` in the reference's tree
    (its leaves named as ``checkpoint._flatten_with_names`` names them)."""
    from repro_torch.train.checkpoint import _flatten_with_names, _unflatten
    prefix = f"{case}/{tag}/"
    names = {k[len(prefix):]: v for k, v in jx.items()
             if k.startswith(prefix)}
    assert set(names) == set(_flatten_with_names(like)), case
    return _unflatten(like, names)


def _full_state(state) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.train.checkpoint import _flatten_with_names
    return {n: (v.full_tensor() if isinstance(v, DTensor) else v
                ).detach().clone()
            for n, v in _flatten_with_names(state).items()}


def assert_close(got: dict, want: dict, before: dict, lr: float,
                 what: str) -> None:
    """``got`` within the compare limits of ``want``, each leaf's |g| from
    ``want``'s second moments after the step and ``before``'s."""
    from repro_torch.train.compare import state_ratios, step_grads
    got = {n: torch.from_numpy(_np(v)) for n, v in got.items()}
    want = {n: torch.from_numpy(_np(v)) for n, v in want.items()}
    before = {n: torch.from_numpy(_np(v)) for n, v in before.items()}
    suffixes = [n[len(".params"):] for n in want if n.startswith(".params")]
    grads = [{x: step_grads(want[".opt.nu" + x], before[".opt.nu" + x])
              for x in suffixes}]
    r = state_ratios(want, got, grads, [lr], GRAD_TOL)
    assert r["params_diff_over_tol"] <= 1.0, (what, r)
    assert r["moments_diff_over_tol"] <= 1.0, (what, r)


def _axes_leaves(tree) -> list:
    """The logical-axes tuples of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _axes_leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _axes_leaves(v)]
    return [tree]


def check_shard_shapes(state, bundle, mesh) -> None:
    """Every parameter's and moment's local shard has the shape that
    ``spec_for_shape`` resolves for it."""
    from repro_torch.dist.sharding import mesh_sizes, spec_for_shape
    from repro_torch.train.checkpoint import _flatten_with_names
    sizes = mesh_sizes(mesh)
    axes = dict(zip(_flatten_with_names(bundle.param_structs()),
                    _axes_leaves(bundle.param_axes()), strict=True))
    for name, t in _flatten_with_names(state).items():
        if name == ".opt.step":
            continue
        key = name[len(".params"):] if name.startswith(".params") else \
            name[len(".opt.mu"):]
        spec = spec_for_shape(axes[key], t.shape, mesh)
        want = []
        for dim, entry in zip(t.shape, spec, strict=True):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            want.append(dim // int(np.prod([sizes[a] for a in names])))
        assert tuple(t.to_local().shape) == tuple(want), (name, spec)


def run_train(world: int, init: dict, out: str) -> dict:
    """Each case of ``world`` from the reference's initial state: the
    port's single-process step and its sharded step (local shard shapes
    checked before and after), held against each other; world 4 saves
    its starcoder2 state for the elastic restore.  Returns, per case, the
    sharded state's global arrays and the state before the step."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import token_batch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop as tl
    got = {}
    for case in cases_of(world):
        arch, shape, axes = TRAIN_CASES[case]
        cfg, bundle, mesh, tc, stream, sshape = _setup(arch, shape, axes)
        before_np = _reference_tree(init, case, "before",
                                    tl.init_train_state(bundle, 0))
        # the port's single-process step from the reference's state
        single = tl.train_state_from_numpy(cfg, before_np, device="cpu")
        single, ms = tl.make_train_step(bundle, tc)(
            single, token_batch(stream, 0, device="cpu"))
        # the sharded step from the same state
        sharded = tl.shard_train_state(
            tl.train_state_from_numpy(cfg, before_np, device="cpu"),
            tl.state_shardings(bundle, mesh))
        check_shard_shapes(sharded, bundle, mesh)
        sharded, mm = tl.make_train_step(bundle, tc, mesh=mesh,
                                         shape=sshape)(
            sharded, token_batch(stream, 0, device="cpu", mesh=mesh))
        check_shard_shapes(sharded, bundle, mesh)
        assert not any(isinstance(v, DTensor) for v in mm.values())
        before = _full_state(tl.train_state_from_numpy(cfg, before_np,
                                                       device="cpu"))
        got[case] = (_full_state(sharded), before)
        assert_close(got[case][0], _full_state(single), before,
                     float(ms["lr"]), f"{case}: sharded vs single-process")
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(float(mm[k]), float(ms[k]),
                                       rtol=1e-5, err_msg=f"{case} {k}")
        if case == ELASTIC:
            ckpt.save_checkpoint(os.path.join(out, "elastic"), 1, sharded,
                                 num_shards=3)
    return got


def check_train_against_jax(got: dict, jx: dict) -> None:
    """Each case's sharded state within the compare limits of the
    reference's step on a forced host mesh of the same shape."""
    from repro_torch.models.registry import build_model
    from repro_torch.train import train_loop as tl
    for case, (state, before) in got.items():
        arch, _, _ = TRAIN_CASES[case]
        cfg, *_ = _setup_config(arch)
        like = tl.init_train_state(build_model(cfg, device="cpu"), 0)
        after_np = _reference_tree(jx, case, "after", like)
        assert_close(state, _full_state(tl.train_state_from_numpy(
            cfg, after_np, device="cpu")), before, float(jx[f"{case}/lr"]),
            f"{case}: sharded vs the reference's step")


def check_elastic(out: str, wait_s: float = 300.0) -> None:
    """World 4's saved starcoder2 state restored onto this world's
    ("data",) mesh, then stepped."""
    from repro_torch.data.pipeline import token_batch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop as tl
    directory = os.path.join(out, "elastic")
    end = time.monotonic() + wait_s
    while ckpt.latest_step(directory) != 1:
        if time.monotonic() > end:
            raise RuntimeError("world 4 saved no checkpoint")
        time.sleep(0.1)
    arch, _, _ = TRAIN_CASES[ELASTIC]
    cfg, bundle, mesh, tc, stream, sshape = _setup(arch, (2,), ("data",))
    like = tl.init_train_state(bundle, 0)
    saved = ckpt.restore_checkpoint(directory, 1, like, device="cpu")
    restored = ckpt.restore_checkpoint(
        directory, 1, like, device="cpu",
        shardings=tl.state_shardings(bundle, mesh))
    check_shard_shapes(restored, bundle, mesh)
    want = _full_state(saved)
    for name, t in _full_state(restored).items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name
    before = _full_state(saved)
    single, ms = tl.make_train_step(bundle, tc)(
        saved, token_batch(stream, 1, device="cpu"))
    restored, mm = tl.make_train_step(bundle, tc, mesh=mesh, shape=sshape)(
        restored, token_batch(stream, 1, device="cpu", mesh=mesh))
    assert_close(_full_state(restored), _full_state(single), before,
                 float(ms["lr"]), "elastic restore's next step")


def worker(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    # A rank left waiting in a collective fails the run within a minute.
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got, jx = {}, {}

        def train():
            got.update(run_train(world, load_jax(out, f"jax_init_{world}"),
                                 out))
            jx.update(load_jax(out, f"jax_{world}"))

        for part, run in (
                ("matmuls", lambda: check_matmuls(rank, world)),
                ("sharded step", train),
                ("compression", lambda: check_compression(rank, world, jx)),
                ("pipeline", lambda: check_pipeline(rank, world, jx)),
                ("step against the reference",
                 lambda: check_train_against_jax(got, jx)),
                ("elastic restore", lambda: world != 2 or check_elastic(out))):
            run()
            dist.barrier()
            if rank == 0:
                print(f"ok {part} world={world}", flush=True)
    finally:
        dist.destroy_process_group()


def check_launcher(out: str) -> None:
    """``launch/train.py`` under torchrun on two ranks: it resumes the
    one-device launcher's checkpoint of step 1 onto a ("data",) mesh of
    two and trains step 1 there; rank 0 alone prints and writes the
    record.  (A ``model`` dim costs a first step of about 15 s on the CPU,
    DTensor's sharding propagation; the worlds train on 2 x 2.)"""
    record = os.path.join(out, "launcher.json")
    argv = ["-m", "repro_torch.launch.train", "--arch", "starcoder2-3b",
            "--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--ckpt-dir", os.path.join(out, "launcher_ckpt"),
            "--ckpt-every", "1", "--record", record]

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return proc.stdout

    run([sys.executable, *argv, "--steps", "1"])
    got = run([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", *argv, "--steps", "2"])
    assert got.count("params on cpu") == 1 and "data=2" in got, got
    assert got.count("resumed from step 1") == 1, got
    with open(record) as f:
        rec = json.load(f)
    assert rec["mesh"] == {"data": 2}, rec
    assert rec["first_step"] == 1 and len(rec["losses"]) == 1, rec
    print("ok launcher under torchrun world=2", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--out", default=None,
                        help="directory for the JAX side's results "
                             "(a temporary one by default)")
    parser.add_argument("--jax-side", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.jax_side:
        try:
            jax_side(args.out, args.worlds)
        except BaseException:
            open(os.path.join(args.out, "jax.failed"), "w").close()
            raise
        return 0
    if 2 in args.worlds and 4 not in args.worlds:
        raise SystemExit("world 2 restores world 4's checkpoint: run both")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or tmp
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={max(args.worlds)} "
            + os.environ.get("XLA_FLAGS", "")))
        jax_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--jax-side",
             "--out", out, "--worlds", *map(str, args.worlds)], env=env)
        worlds = []
        pool = concurrent.futures.ThreadPoolExecutor(1)
        try:
            launcher = pool.submit(check_launcher, out)
            # The worlds run side by side, each on its own port.
            worlds = [mp.spawn(worker, args=(world, free_port(), out),
                               nprocs=world, join=False)
                      for world in args.worlds]
            pending = list(worlds)
            while pending:      # a failure in any world ends the run
                pending = [ctx for ctx in pending
                           if not ctx.join(timeout=0.5)]
            launcher.result()
        except BaseException:
            jax_proc.kill()
            for ctx in worlds:
                for proc in ctx.processes:
                    proc.terminate()
            raise
        finally:
            jax_proc.wait(timeout=300)
            pool.shutdown()
        if jax_proc.returncode != 0:
            raise RuntimeError(f"the JAX side exited {jax_proc.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
