"""Shared pieces of the training parity tests (tests/test_torch_train*.py):
the reduced configs in fp32 compute, the reference's trajectory from its
own jitted ``make_train_step`` on a one-device mesh (cached per
microbatch count and config), the port's steps from a state carried
across as numpy arrays, and the state comparison with its tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.configs.common import ShapeSpec
from repro.data import pipeline as jdata
from repro.models.registry import build_model as jbuild_model
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.checkpoint import _flatten_with_names

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


def reference_trajectory(mb: int, arch="starcoder2-3b", steps=STEPS):
    """The reference's TrainState (numpy) before each step and after the
    last, and its metrics of each step, from its jitted step."""
    key = (mb, arch, steps)
    if key not in _TRAJ:
        jcfg, _ = _configs(arch)
        bundle = jbuild_model(jcfg)
        mesh = jax.make_mesh((1,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
        shape = ShapeSpec("smoke", seq_len=SEQ, global_batch=BATCH,
                          kind="train")
        tc = jloop.TrainConfig(microbatches=mb,
                               opt=jopt.OptimizerConfig(**OPT))
        jstream, _ = _stream()
        states, metrics = [], []
        with mesh:
            state = jloop.init_train_state(bundle, mesh,
                                           jax.random.PRNGKey(0))
            step = jloop.make_train_step(bundle, mesh, tc, shape)
            for i in range(steps):
                states.append(jax.tree.map(np.array, state))
                state, m = step(state, jdata.token_batch(jstream, i))
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
    _, tstream = _stream()
    metrics = []
    for i in range(first, last):
        state, m = step(state, tdata.token_batch(tstream, i, device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


GRAD_TOL = 1e-4      # of a leaf's largest gradient


def assert_state_close(port_state, ref_states: list, lrs: list):
    """The port's state against ``ref_states[-1]``, the reference's after
    the steps from ``ref_states[0]`` with learning rates ``lrs``.

    The moments within GRAD_TOL of each leaf's largest (mu is a sum of
    gradients, nu of their squares: twice that).  A parameter within 1e-6
    + 1e-5 of itself plus, for each step s, what a gradient error of
    GRAD_TOL x the leaf's largest gradient can move AdamW's step
    m / (sqrt(v) + eps): at most 2 x lr_s x that error / (|g_s| + eps),
    capped at the step's own 2 x lr_s, with |g_s| from the reference's
    second moments before and after step s.  Only a gradient that is zero
    up to rounding (a key bias in a slow RoPE channel shifts every key's
    logit nearly alike, which the softmax cancels; a gated unit that is
    off) gets more than the base tolerance, and then for its step only."""
    got = _flatten_with_names(port_state)
    want = _flatten_with_names(ref_states[-1])
    flat = [_flatten_with_names(st) for st in ref_states]
    assert set(got) == set(want)
    for name, w in want.items():
        w, g = _np(w), _np(got[name])
        if name.startswith(".opt.step"):
            assert int(g) == int(w)
            continue
        if name.startswith((".opt.mu", ".opt.nu")):
            scale = (2.0 if name.startswith(".opt.nu") else 1.0) * GRAD_TOL
            np.testing.assert_allclose(
                g, w, atol=scale * float(np.abs(w).max()) + 1e-12,
                err_msg=name)
            continue
        nu_name = ".opt.nu" + name[len(".params"):]
        tol = 1e-6 + 1e-5 * np.abs(w)
        for s, lr in enumerate(lrs):
            v0, v1 = _np(flat[s][nu_name]), _np(flat[s + 1][nu_name])
            gs = np.sqrt(np.maximum(v1 - 0.95 * v0, 0.0) / 0.05)
            err = GRAD_TOL * float(gs.max())
            tol = tol + lr * np.minimum(2.0, 2.0 * err / (gs + 1e-8))
        bad = np.abs(g - w) > tol
        assert not bad.any(), (name, float(np.abs(g - w).max()),
                               int(bad.sum()))


def check_steps_against_reference(mb: int, arch: str = "starcoder2-3b"):
    """One and three steps with ``mb`` microbatches: the loss and every
    metric of each step, then every updated parameter and moment, against
    the reference's jitted step."""
    _, tcfg = _configs(arch)
    states, ref_metrics = reference_trajectory(mb, arch)
    state, metrics = port_steps(tcfg, states[0], 0, 3, mb)
    for i, (got, want) in enumerate(zip(metrics, ref_metrics[:3],
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
    assert_state_close(state, states[:4], lrs[:3])
    one, _ = port_steps(tcfg, states[0], 0, 1, mb)
    assert_state_close(one, states[:2], lrs[:1])
