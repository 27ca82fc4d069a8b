"""Training the M-RoPE VLM on the port against the JAX package on the CPU:
reduced qwen2-vl-72b (M-RoPE sections, 4 patch positions), seeded patch
embeddings and (B, S, 3) M-RoPE positions, fp32 compute, the reference's
state carried across as numpy arrays, one and two steps at one and two
microbatches against the reference's jitted ``make_train_step``; the
training forward's out-of-place patch stub against the serving path's
in-place write.

Tolerances: those of tests/test_torch_train.py (``torch_train_parity``);
the two patch writes bit-equal.
"""

import pytest
import torch

from repro_torch.models import transformer as ttf

from torch_train_parity import (_configs, check_steps_against_reference,
                                reference_trajectory, torch_batch)

ARCH = "qwen2-vl-72b"


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_jax(mb):
    check_steps_against_reference(mb, ARCH, steps=2)


def test_patch_stub_out_of_place_equals_the_serving_write():
    """``embed_inputs(autograd=True)`` joins the patches out of place and
    gives the serving path's bits; the gradient reaches the embedding rows
    of the text positions only."""
    _, tcfg = _configs(ARCH)
    states, _ = reference_trajectory(1, ARCH)
    params = ttf.params_from_numpy(tcfg, states[0].params, device="cpu")
    batch = torch_batch(ARCH, 0)
    assert batch["positions"].shape == batch["tokens"].shape + (3,)
    args = (tcfg, params, batch["tokens"], batch["positions"],
            batch["patch_embeds"])
    with torch.no_grad():
        served = ttf.embed_inputs(*args)
    params["embed"].requires_grad_(True)
    trained = ttf.embed_inputs(*args, autograd=True)
    assert torch.equal(trained.detach(), served)
    p = tcfg.num_patch_tokens
    trained[:, :p].sum().backward(retain_graph=True)
    assert params["embed"].grad is None or not params["embed"].grad.any()
    trained[:, p:].sum().backward()
    assert params["embed"].grad.any()
