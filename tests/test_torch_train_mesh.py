"""The sharded train step at world size 1 on the CPU: on a (1, 1)
("data", "model") mesh it equals the mesh-less step bit for bit.

One module fixture owns an in-process gloo group on a ``HashStore`` (as
tests/test_torch_dist.py does), so no other test sees it.  For one reduced
config of each family (dense starcoder2-3b, MoE qwen3-moe-30b-a3b,
recurrent rwkv6-1.6b and recurrentgemma-2b, VLM qwen2-vl-72b,
encoder-decoder whisper-tiny) two steps of two microbatches in fp32 run
through ``make_train_step(bundle, cfg)`` and through ``make_train_step(...,
mesh=)`` from the same seeded state and token stream: every metric and
every leaf of the state bit-equal.  No op needed an exception: DTensor's
propagation gives the mesh-less bits on every path (the MoE layer runs
its routing on local tensors, models/moe.py), so nothing is held to
``repro_torch.train.compare``'s limits here.  Beside it: the mesh's
placements, ``token_batch`` on a mesh, the sharded checkpoint's round trip
and ``constrain`` under a mesh.  Worlds 2 and 4 run in
tests/test_torch_dist_train.py.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.configs.common import ShapeSpec
from repro_torch.data.pipeline import (TokenStreamConfig, batch_placements,
                                      local_rows, token_batch)
from repro_torch.dist import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop as tl
from repro_torch.train.checkpoint import _flatten_with_names
from repro_torch.train.optimizer import OptimizerConfig

SEQ, BATCH, MICRO, STEPS = 32, 4, 2, 2
FAMILIES = ["starcoder2-3b", "qwen3-moe-30b-a3b", "rwkv6-1.6b",
            "recurrentgemma-2b", "qwen2-vl-72b", "whisper-tiny"]


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    yield shd.make_mesh((1, 1), ("data", "model"), device="cpu")
    dist.destroy_process_group()


def _setup(arch: str):
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              compute_dtype=torch.float32)
    bundle = build_model(cfg, device="cpu")
    tc = tl.TrainConfig(microbatches=MICRO, loss_chunk=16,
                        opt=OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                            total_steps=10))
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    return bundle, tc, stream, ShapeSpec("t", SEQ, BATCH, "train")


def _global(state) -> dict:
    return {n: v.full_tensor() if isinstance(v, DTensor) else v
            for n, v in _flatten_with_names(state).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_step_at_one_rank_is_the_mesh_less_step(mesh, arch):
    bundle, tc, stream, shape = _setup(arch)
    plain = tl.init_train_state(bundle, 0)
    sharded = tl.init_train_state(bundle, 0, mesh=mesh)
    assert all(isinstance(p, DTensor)
               for p in _flatten_with_names(sharded.params).values())
    step = tl.make_train_step(bundle, tc)
    sharded_step = tl.make_train_step(bundle, tc, mesh=mesh, shape=shape)
    for i in range(STEPS):
        plain, want = step(plain, tl.train_batch(bundle, stream, i))
        sharded, got = sharded_step(
            sharded, tl.train_batch(bundle, stream, i, mesh=mesh))
        assert set(got) == set(want)
        for k in want:
            assert not isinstance(got[k], DTensor), k
            assert torch.equal(got[k], want[k]), (i, k)
    a, b = _global(plain), _global(sharded)
    assert list(a) == list(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_placements_follow_the_rules(mesh):
    bundle, *_ = _setup("qwen3-moe-30b-a3b")
    sh = tl.state_shardings(bundle, mesh)
    assert sh.opt.step is None and sh.opt.mu is sh.params
    assert sh.params["embed"].mesh is mesh
    # a dim of one rank splits nothing: every placement is Replicate()
    for leaf in _flatten_with_names(sh.params).values():
        assert leaf.placements == (Replicate(), Replicate())
    sizes = {"data": 2, "model": 4}
    spec = shd.spec_for_shape(("experts", "fsdp", "expert_mlp"),
                              (8, 64, 32), sizes)
    assert spec == (None, "data", "model")       # expert_mlp claims first
    pl = shd.placements(spec, sizes)
    assert pl == (shd.Shard(1), shd.Shard(2))
    assert shd.placements((("pod", "data"), None),
                          {"pod": 2, "data": 2, "model": 1}) == (
        shd.Shard(0), shd.Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements((("data", "pod"),), {"pod": 2, "data": 2})


def test_token_batch_on_a_mesh_is_the_batch(mesh):
    stream = TokenStreamConfig(vocab_size=512, seq_len=SEQ,
                               global_batch=BATCH)
    for mrope in (False, True):
        want = token_batch(stream, 3, device="cpu", mrope=mrope)
        got = token_batch(stream, 3, device="cpu", mrope=mrope, mesh=mesh)
        for k in want:
            assert isinstance(got[k], DTensor)
            assert torch.equal(got[k].full_tensor(), want[k]), k
    # the rules table places the batch: over data where it divides the
    # rows, replicated where it does not, or where the rules give it none
    two = _TwoDataRanks()
    assert batch_placements(4, two) == (Shard(0),)
    assert local_rows(4, two, batch_placements(4, two)).tolist() == [2, 3]
    assert batch_placements(3, two) == (Replicate(),)
    assert local_rows(3, two, batch_placements(3, two)).tolist() == [0, 1, 2]
    assert batch_placements(4, two, dict(shd.DEFAULT_RULES, batch=())) == (
        Replicate(),)


class _TwoDataRanks:
    """Rank 1 of a ("data",) mesh of two, as ``local_rows`` reads one."""
    mesh_dim_names = ("data",)
    shape = (2,)

    @staticmethod
    def get_coordinate():
        return [1]

    @staticmethod
    def size(i):
        return 2


def test_sharded_checkpoint_round_trip(mesh, tmp_path):
    bundle, tc, stream, shape = _setup("starcoder2-3b")
    state = tl.init_train_state(bundle, 0, mesh=mesh)
    state, _ = tl.make_train_step(bundle, tc, mesh=mesh, shape=shape)(
        state, tl.train_batch(bundle, stream, 0, mesh=mesh))
    ckpt.save_checkpoint(str(tmp_path), 1, state, num_shards=2)
    like = tl.init_train_state(bundle, 0)
    plain = ckpt.restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    back = ckpt.restore_checkpoint(
        str(tmp_path), 1, like, device="cpu",
        shardings=tl.state_shardings(bundle, mesh))
    for name, v in _global(state).items():
        assert torch.equal(_global(plain)[name], v), name
        assert torch.equal(_global(back)[name], v), name
    assert all(isinstance(p, DTensor) and p.requires_grad
               for p in _flatten_with_names(back.params).values())


def test_constrain_under_a_mesh(mesh):
    x = torch.arange(12.0).reshape(2, 3, 2)
    assert shd.constrain(x, ("batch", "seq", "embed")) is x
    d = shd.distribute(x, shd.sharding_for(None, x.shape, mesh))
    with shd.activation_rules(mesh):
        y = shd.constrain(d, ("batch", "seq", "embed"))
        assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), x)
        with pytest.raises(TypeError, match="not a DTensor"):
            shd.constrain(x, ("batch", "seq", "embed"))
    assert shd.constrain(d, ("batch", "seq", "embed")) is d
