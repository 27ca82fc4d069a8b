"""Expert parallelism's per-rank share of the MoE layer, in one process
(``models.moe.apply_moe_share``): what each ``model`` rank computes under
a mesh whose ``model`` dim divides the experts (routing over all experts,
dispatch to and combine from its own E/m, its columns of llama4's shared
expert), with no process group.

* The m shares' partial outputs, summed in rank order, against the whole
  layer (``apply_moe``) within 1e-6 of its largest |output| in fp32 (the
  sum of m partial outputs rounds in another order), and against the
  reference's ``apply_moe`` within ``apply_moe``'s own 2e-5
  (tests/test_torch_moe.py); the reduced qwen3-moe-30b-a3b layer (8
  experts, top-2) at m = 2 and 4 and the reduced llama4-scout-17b-a16e
  layer (4 experts, top-1, a shared expert) at m = 4, at a capacity
  factor that drops assignments.
* The full range (m = 1) is ``apply_moe``'s output bit for bit.
* A rank count that does not divide the experts raises.

The sharded steps that run these shares over gloo are held in
tests/torch_dist_train_checks.py (tests/test_torch_dist_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe

# arch -> (capacity factor that drops, model ranks)
CASES = [("qwen3-moe-30b-a3b", 1.0, 2), ("qwen3-moe-30b-a3b", 1.0, 4),
         ("llama4-scout-17b-a16e", 1.0, 4)]
B, T = 2, 48


def _layer(arch: str, cf: float):
    """The reduced config's MoE layer: its ``MoEConfig`` at capacity
    factor ``cf``, seeded weights (with llama4's shared expert) and a
    seeded input, as numpy arrays."""
    cfg = tconfigs.get_reduced(arch)
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
    d, f, e = cfg.d_model, cfg.moe_d_ff, moe_cfg.num_experts
    rng = np.random.default_rng(3)

    def normal(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {"router": normal(d, e, fan_in=d), "w_in": normal(e, d, f, fan_in=d),
         "w_gate": normal(e, d, f, fan_in=d),
         "w_out": normal(e, f, d, fan_in=f)}
    shared = None
    if cfg.shared_expert_ff:
        sf = cfg.shared_expert_ff
        shared = {"w_in": normal(d, sf, fan_in=d),
                  "w_gate": normal(d, sf, fan_in=d),
                  "w_out": normal(sf, d, fan_in=sf)}
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    return cfg, moe_cfg, p, shared, x


def _torch(tree):
    if tree is None:
        return None
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch,cf,ranks", CASES)
def test_shares_sum_to_the_layer(arch, cf, ranks):
    cfg, moe_cfg, p, shared, x = _layer(arch, cf)
    tp, ts, tx = _torch(p), _torch(shared), torch.from_numpy(x)
    whole, _ = tmoe.apply_moe(tp, tx, moe_cfg, act=cfg.act, shared_mlp=ts)
    total = torch.zeros_like(whole)
    for rank in range(ranks):
        total = total + tmoe.apply_moe_share(tp, tx, moe_cfg, rank, ranks,
                                             act=cfg.act, shared_mlp=ts)
    scale = float(whole.abs().max())
    assert float((total - whole).abs().max()) <= 1e-6 * scale
    # assignments were dropped: each share's combine leaves them out
    sp = tmoe._group_size(B * T, moe_cfg.group_tokens)
    top_w, top_i, _ = tmoe.route((tx.reshape(-1, sp, tx.shape[-1])
                                  @ tp["router"]), moe_cfg)
    _, keep = tmoe.assign_slots(top_w, top_i, moe_cfg)
    assert 0 < int((~keep).sum()) < keep.numel()
    # and the reference's layer on the same inputs
    jcfg = jmoe.MoEConfig(**dataclasses.asdict(moe_cfg))
    want, _ = jax.jit(lambda p, s, x: jmoe.apply_moe(
        p, x, jcfg, act=cfg.act, shared_mlp=s))(
            jax.tree.map(jnp.asarray, p),
            None if shared is None else jax.tree.map(jnp.asarray, shared),
            jnp.asarray(x))
    np.testing.assert_allclose(total.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_the_full_range_is_the_layer_bit_for_bit(arch):
    cfg, moe_cfg, p, shared, x = _layer(arch, 1.0)
    tp, ts, tx = _torch(p), _torch(shared), torch.from_numpy(x)
    whole, _ = tmoe.apply_moe(tp, tx, moe_cfg, act=cfg.act, shared_mlp=ts)
    assert torch.equal(tmoe.apply_moe_share(tp, tx, moe_cfg, 0, 1,
                                            act=cfg.act, shared_mlp=ts),
                       whole)


def test_ranks_that_do_not_divide_the_experts_raise():
    cfg, moe_cfg, p, _, x = _layer("qwen3-moe-30b-a3b", 1.0)
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.apply_moe_share(_torch(p), torch.from_numpy(x), moe_cfg, 0, 3)
