"""Shared pieces of the training parity tests (tests/test_torch_train*.py):
the reduced configs in fp32 compute, the reference's trajectory from its
own jitted ``make_train_step`` on a one-device mesh (cached per
microbatch count and config), the port's steps from a state carried
across as numpy arrays, and the state comparison with its tolerances.
A batch holds the config's stub inputs, seeded (``extras``), and M-RoPE
positions under M-RoPE, fed alike to both sides.

The reference's trajectory takes one derivative exactly: a top-1 router
under "topk_then_softmax" weights its expert by p / p, which is 1 with
derivative 0, but autodiff of the division leaves a rounding residue a
token that lands in the router's gradient.  Where that gradient's true
value is small (llama4-scout's routers learn from the 0.01-weighted aux
loss alone) the residue is as large as the tolerance, so the trajectory
the port is held to has ``stop_gradient`` on that weight (``exact_route``),
the exact derivative of the reference's own function; the reference's
autodiff is held to it in tests/test_torch_train_moe.py.
"""

import dataclasses
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.common import ShapeSpec
from repro.data import pipeline as jdata
from repro.models import moe as jmoe
from repro.models.registry import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.checkpoint import _flatten_with_names
from repro_torch.train.compare import state_ratios, step_grads

SEQ, BATCH = 32, 4
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _stream(vocab=512):
    kw = dict(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)
    return jdata.TokenStreamConfig(**kw), tdata.TokenStreamConfig(**kw)


def extras(arch: str) -> dict:
    """The config's stub inputs for a batch of BATCH rows, seeded: an
    encoder-decoder's frames (B, F, D), a VLM's patch embeddings (B, P,
    D)."""
    cfg = tconfigs.get_reduced(arch)
    rng = np.random.default_rng(7)
    out = {}
    if hasattr(cfg, "num_frames"):
        out["frames"] = rng.normal(size=(BATCH, cfg.num_frames, cfg.d_model))
    if getattr(cfg, "num_patch_tokens", 0):
        out["patch_embeds"] = rng.normal(
            size=(BATCH, cfg.num_patch_tokens, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _mrope(arch: str) -> bool:
    return bool(getattr(tconfigs.get_reduced(arch), "mrope_section", None))


def jax_batch(arch: str, step: int) -> dict:
    jstream, _ = _stream()
    batch = jdata.token_batch(jstream, step, mrope=_mrope(arch))
    batch.update({k: jnp.asarray(v) for k, v in extras(arch).items()})
    return batch


def torch_batch(arch: str, step: int) -> dict:
    _, tstream = _stream()
    batch = tdata.token_batch(tstream, step, device="cpu",
                              mrope=_mrope(arch))
    batch.update({k: torch.from_numpy(v) for k, v in extras(arch).items()})
    return batch


def _configs(arch="starcoder2-3b", **over):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               compute_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               compute_dtype=torch.float32, **over)
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# The reference's trajectory, once per microbatch count
# ---------------------------------------------------------------------------

_TRAJ: dict = {}


def exact_route(route):
    """The reference's ``route`` with the top-1 renormalised weight p / p
    (exactly 1, derivative exactly 0) under ``stop_gradient``: the same
    values, and the derivative without the division's rounding residue.
    Any other routing is returned as it is."""
    def wrapped(logits, cfg):
        top_w, top_i, aux = route(logits, cfg)
        if cfg.top_k == 1 and cfg.router_softmax_order == "topk_then_softmax":
            top_w = jax.lax.stop_gradient(top_w)
        return top_w, top_i, aux
    return wrapped


def reference_trajectory(mb: int, arch="starcoder2-3b", steps=STEPS,
                         exact: bool = True):
    """The reference's TrainState (numpy) before each step and after the
    last, and its metrics of each step, from its jitted step, traced with
    ``exact_route`` unless ``exact`` is False.  A second trajectory of the
    same config starts from the first one's initial state (the same
    values, placed in the step's shardings; its jitted init compiles
    once)."""
    key = (mb, arch, steps, exact)
    if key not in _TRAJ:
        init = next((st[0] for (_, a, _, _), (st, _) in _TRAJ.items()
                     if a == arch), None)
        jcfg, _ = _configs(arch)
        bundle = jbuild_model(jcfg)
        mesh = jax.make_mesh((1,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        shape = ShapeSpec("smoke", seq_len=SEQ, global_batch=BATCH,
                          kind="train")
        tc = jloop.TrainConfig(microbatches=mb,
                               opt=jopt.OptimizerConfig(**OPT))
        states, metrics = [], []
        route = exact_route(jmoe.route) if exact else jmoe.route
        with mesh, unittest.mock.patch.object(jmoe, "route", route):
            state = (jloop.init_train_state(bundle, mesh,
                                            jax.random.PRNGKey(0))
                     if init is None else jax.device_put(
                         init, jloop.state_shardings(bundle, mesh)))
            step = jloop.make_train_step(bundle, mesh, tc, shape)
            for i in range(steps):
                states.append(jax.tree.map(np.array, state))
                state, m = step(state, jax_batch(arch, i))
                metrics.append({k: float(v) for k, v in m.items()})
            states.append(jax.tree.map(np.array, state))
        _TRAJ[key] = (states, metrics)
    return _TRAJ[key]


def port_steps(tcfg, state_np, first: int, last: int, mb: int):
    """The port's state carried over from ``state_np`` and stepped from
    step ``first`` to ``last``; returns (state, metrics of each step)."""
    bundle = tbuild_model(tcfg, device="cpu")
    state = tloop.train_state_from_numpy(tcfg, state_np, device="cpu")
    step = tloop.make_train_step(
        bundle, tloop.TrainConfig(microbatches=mb,
                                  opt=topt.OptimizerConfig(**OPT)))
    metrics = []
    for i in range(first, last):
        state, m = step(state, torch_batch(tcfg.name, i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


GRAD_TOL = 1e-4      # of a leaf's largest gradient


def assert_state_close(port_state, ref_states: list, lrs: list):
    """The port's state against ``ref_states[-1]``, the reference's after
    the steps from ``ref_states[0]`` with learning rates ``lrs``, by
    ``repro_torch.train.compare``'s rule at GRAD_TOL (its module docstring
    states it), each step's |g| from the reference's second moments
    before and after it."""
    def flat(state):
        return {n: torch.from_numpy(_np(x))
                for n, x in _flatten_with_names(state).items()}

    want, states = flat(ref_states[-1]), [flat(st) for st in ref_states]
    suffixes = [n[len(".params"):] for n in want if n.startswith(".params")]
    grads = [{x: step_grads(after[".opt.nu" + x], before[".opt.nu" + x])
              for x in suffixes}
             for before, after in zip(states, states[1:])]
    r = state_ratios(want, flat(port_state), grads, lrs, GRAD_TOL)
    assert r["params_diff_over_tol"] <= 1.0, r
    assert r["moments_diff_over_tol"] <= 1.0, r


def check_steps_against_reference(mb: int, arch: str = "starcoder2-3b",
                                  steps: int = 3):
    """One and ``steps`` steps with ``mb`` microbatches: the loss and every
    metric of each step, then every updated parameter and moment, against
    the reference's jitted step.  Returns the port's metrics of each
    step."""
    _, tcfg = _configs(arch)
    states, ref_metrics = reference_trajectory(mb, arch)
    state, metrics = port_steps(tcfg, states[0], 0, steps, mb)
    for i, (got, want) in enumerate(zip(metrics, ref_metrics[:steps],
                                        strict=True)):
        for k in ("loss", "nll"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(got["z_loss"], want["z_loss"], rtol=1e-4)
        assert abs(got["accuracy"] - want["accuracy"]) <= 1e-6
        for k in ("lr", "aux_loss"):
            assert abs(got[k] - want[k]) <= 1e-6 * abs(want[k]) + 1e-12, k
        for k in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    lrs = [m["lr"] for m in ref_metrics]
    assert_state_close(state, states[:steps + 1], lrs[:steps])
    one, _ = port_steps(tcfg, states[0], 0, 1, mb)
    assert_state_close(one, states[:2], lrs[:1])
    return metrics


def check_layout_reads_across(arch: str, directory) -> None:
    """The reference's state after two steps, carried across: the JAX
    package restores the port's checkpoint of it bit for bit, and the port
    the reference's, into the port's tree."""
    states, _ = reference_trajectory(1, arch)
    tree_np = states[2]
    _, tcfg = _configs(arch)
    tstate = tloop.train_state_from_numpy(tcfg, tree_np, device="cpu")
    tckpt.save_checkpoint(str(directory / "port"), 2, tstate, num_shards=4)
    structs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           tree_np)
    back = jckpt.restore_checkpoint(str(directory / "port"), 2, structs)
    for x, y in zip(jax.tree.leaves(tree_np), jax.tree.leaves(back),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    jckpt.save_checkpoint(str(directory / "ref"), 2,
                          jax.tree.map(jnp.asarray, tree_np), num_shards=2)
    got = tckpt.restore_checkpoint(
        str(directory / "ref"), 2,
        topt.tree_map(lambda t: t.to("meta"), tstate), device="cpu")
    for x, y in zip(topt.tree_leaves(tstate), topt.tree_leaves(got),
                    strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert all(t.requires_grad for t in topt.tree_leaves(got.params))
