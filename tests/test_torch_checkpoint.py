"""The port's checkpointing and straggler monitor: the reference's own
checkpoint tests (tests/test_train_substrate.py) restated for the port
(round trip with bf16 and a 0-dim step, retention, no partial directory
visible, restore across shard counts and onto another device, a bit-exact
restart), the layout read across in both directions (the JAX package
restores what the port wrote and the port what the JAX package wrote),
the launcher's resume, and the straggler tests.  Restarts compare with
tolerance 0: the same operations on the same bits give the same bits.
"""

import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.train.straggler import (StragglerConfig, StragglerMonitor)


@pytest.fixture
def ckpt_dir(tmp_path):
    return str(tmp_path / "ckpts")


def _bundle():
    return build_model(tconfigs.get_reduced("starcoder2-3b"), device="cpu")


def _batch(step):
    return tdata.token_batch(tdata.TokenStreamConfig(
        vocab_size=512, seq_len=32, global_batch=4), step, device="cpu")


def _same(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.cpu(), b.cpu()))


def test_checkpoint_roundtrip(ckpt_dir):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(6, 2),
            "b": {"c": torch.randn(3).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.ones(5, 2, dtype=torch.int64)]}
    path = ckpt.save_checkpoint(ckpt_dir, 3, tree, num_shards=3)
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_000.npz",
                                        "shard_001.npz", "shard_002.npz"]
    assert ckpt.latest_step(ckpt_dir) == 3
    out = ckpt.restore_checkpoint(ckpt_dir, 3, tree, device="cpu")
    assert out["a"] is tree["a"]          # a leaf on the device: in place
    for x, y in zip(topt.tree_leaves(tree), topt.tree_leaves(out),
                    strict=True):
        assert _same(x, y)
    meta = ckpt.restore_checkpoint(
        ckpt_dir, 3, topt.tree_map(lambda t: t.to("meta"), tree),
        device="cpu")
    for x, y in zip(topt.tree_leaves(tree), topt.tree_leaves(meta),
                    strict=True):
        assert y.device.type == "cpu" and _same(x, y)


def test_checkpoint_retention(ckpt_dir):
    tree = {"a": torch.zeros(4)}
    for s in range(6):
        ckpt.save_checkpoint(ckpt_dir, s, tree, keep=2)
    assert ckpt.list_steps(ckpt_dir) == [4, 5]


def test_checkpoint_atomic_no_partial_visible(ckpt_dir):
    tree = {"a": torch.zeros(4)}
    ckpt.save_checkpoint(ckpt_dir, 1, tree)
    # a crashed writer's temporary directory is invisible
    os.makedirs(os.path.join(ckpt_dir, "step_000000009.tmp-dead"))
    assert ckpt.latest_step(ckpt_dir) == 1
    # and so is a directory without its manifest
    os.makedirs(os.path.join(ckpt_dir, "step_000000008"))
    assert ckpt.latest_step(ckpt_dir) == 1


def test_restore_across_shard_counts(ckpt_dir):
    """A train state saved in 8 shards and in 3 restores whole, onto new
    tensors (a meta-device template) and in place."""
    state = tloop.init_train_state(_bundle(), 0)
    for shards in (8, 3):
        d = os.path.join(ckpt_dir, str(shards))
        ckpt.save_checkpoint(d, 0, state, num_shards=shards)
        fresh = ckpt.restore_checkpoint(
            d, 0, topt.tree_map(lambda t: t.to("meta"), state), device="cpu")
        for x, y in zip(topt.tree_leaves(state), topt.tree_leaves(fresh),
                        strict=True):
            assert _same(x, y)
    other = tloop.init_train_state(_bundle(), 1)
    back = ckpt.restore_checkpoint(os.path.join(ckpt_dir, "8"), 0, other,
                                   device="cpu")
    assert back.params["embed"] is other.params["embed"]
    for x, y in zip(topt.tree_leaves(state), topt.tree_leaves(back),
                    strict=True):
        assert _same(x, y)


def test_restart_is_bit_exact(ckpt_dir):
    """Train 4 steps; restart from the step-2 checkpoint; the losses and
    the final state are bit-equal."""
    bundle = _bundle()
    tc = tloop.TrainConfig(opt=topt.OptimizerConfig(
        peak_lr=1e-3, warmup_steps=0, total_steps=10))
    step = tloop.make_train_step(bundle, tc)
    state = tloop.init_train_state(bundle, 0)
    losses_a = []
    for i in range(4):
        if i == 2:
            ckpt.save_checkpoint(ckpt_dir, i, state)
        state, m = step(state, _batch(i))
        losses_a.append(float(m["loss"]))
    state_b = ckpt.restore_checkpoint(
        ckpt_dir, 2, topt.tree_map(lambda t: t.to("meta"), state),
        device="cpu")
    assert all(p.requires_grad for p in topt.tree_leaves(state_b.params))
    losses_b = []
    for i in range(2, 4):
        state_b, m = step(state_b, _batch(i))
        losses_b.append(float(m["loss"]))
    assert losses_a[2:] == losses_b
    for x, y in zip(topt.tree_leaves(state), topt.tree_leaves(state_b),
                    strict=True):
        assert _same(x, y)


def test_the_layout_reads_across_both_ways(ckpt_dir):
    """The JAX package restores the port's checkpoint of the reference's
    state carried across, and the port restores the reference's."""
    jcfg = jconfigs.get_reduced("starcoder2-3b")
    params = jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.PRNGKey(0))
    jstate = jloop.TrainState(params, jopt.init_state(params))
    tree_np = jax.tree.map(np.array, jstate)
    tstate = tloop.train_state_from_numpy(tconfigs.get_reduced(
        "starcoder2-3b"), tree_np, device="cpu")
    ckpt.save_checkpoint(os.path.join(ckpt_dir, "port"), 5, tstate,
                         num_shards=4)
    structs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           jstate)
    back = jckpt.restore_checkpoint(os.path.join(ckpt_dir, "port"), 5,
                                    structs)
    for x, y in zip(jax.tree.leaves(jstate), jax.tree.leaves(back),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    jckpt.save_checkpoint(os.path.join(ckpt_dir, "ref"), 6, jstate,
                          num_shards=2)
    got = ckpt.restore_checkpoint(os.path.join(ckpt_dir, "ref"), 6,
                                  topt.tree_map(lambda t: t.to("meta"),
                                                tstate), device="cpu")
    for x, y in zip(topt.tree_leaves(tstate), topt.tree_leaves(got),
                    strict=True):
        assert _same(x, y)


def test_launcher_resumes_bit_exact(tmp_path, capsys):
    """Four steps in one run against a run resumed from the first run's
    step-2 checkpoint (alone in its directory): the same losses of steps
    3 and 4, bit for bit, and the same step-4 checkpoint."""
    argv = ["--arch", "starcoder2-3b", "--reduced", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-every", "2", "--steps", "4"]
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    whole, part = tmp_path / "whole.json", tmp_path / "part.json"
    assert tlaunch.main(argv + ["--ckpt-dir", str(a_dir), "--record",
                                str(whole)]) == 0
    assert ckpt.list_steps(str(a_dir)) == [2, 4]
    shutil.copytree(a_dir / "step_000000002", b_dir / "step_000000002")
    assert tlaunch.main(argv + ["--ckpt-dir", str(b_dir), "--record",
                                str(part)]) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    a, b = json.loads(whole.read_text()), json.loads(part.read_text())
    assert b["first_step"] == 2 and a["losses"][2:] == b["losses"]
    template = topt.tree_map(lambda t: t.to("meta"),
                             tloop.init_train_state(_bundle(), 0))
    end_a, end_b = (ckpt.restore_checkpoint(str(d), 4, template,
                                            device="cpu")
                    for d in (a_dir, b_dir))
    for x, y in zip(topt.tree_leaves(end_a), topt.tree_leaves(end_b),
                    strict=True):
        assert _same(x, y)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_fires_on_slow_host():
    cfg = StragglerConfig(window=20, tolerance=1.5, patience=3,
                          warmup_steps=0)
    fired = []
    mon = StragglerMonitor(cfg, num_hosts=4,
                           mitigation=lambda ev: fired.append(ev))
    for step in range(30):
        times = [0.10, 0.11, 0.10, 0.10]
        if step >= 10:
            times[2] = 0.40            # host 2 goes bad
        mon.start_step()
        mon.end_step(times)
    assert fired and all(ev.host == 2 for ev in fired)
    assert mon.summary()["events"] >= 1


def test_straggler_quiet_on_uniform_times():
    mon = StragglerMonitor(StragglerConfig(warmup_steps=0), num_hosts=2)
    for _ in range(50):
        mon.start_step()
        mon.end_step([0.1, 0.1])
    assert mon.summary()["events"] == 0


def test_straggler_monitor_without_a_config_takes_the_defaults():
    mon = StragglerMonitor()
    assert mon.cfg == StragglerConfig() and mon.times[0].maxlen == 50
    for _ in range(12):
        mon.start_step()
        mon.end_step()
    assert mon.summary()["steps"] == 12
