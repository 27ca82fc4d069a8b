"""Training the encoder-decoder on the port against the JAX package on the
CPU: reduced whisper-tiny (2 + 2 layers, 16 frames), seeded frames, fp32
compute, the reference's state carried across as numpy arrays, one and
two steps at one and two microbatches against the reference's jitted
``make_train_step``; its checkpoint read across both ways; a restart from
a checkpoint on the port; kernel #10 kept off the training forward.

Tolerances: those of tests/test_torch_train.py (``torch_train_parity``);
the restart compares with tolerance 0 (the same operations on the same
bits give the same bits).
"""

import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.models.registry import build_model as tbuild_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

from torch_train_parity import (_configs, check_layout_reads_across,
                                check_steps_against_reference,
                                reference_trajectory, torch_batch)

ARCH = "whisper-tiny"


@pytest.mark.parametrize("mb", [1, 2])
def test_train_steps_match_jax(mb):
    check_steps_against_reference(mb, ARCH, steps=2)


def test_encdec_checkpoint_reads_across_both_ways(tmp_path):
    check_layout_reads_across(ARCH, tmp_path)


def test_restart_is_bit_exact_and_never_reaches_kernel_10(tmp_path,
                                                          monkeypatch):
    """Four steps with seeded frames, a checkpoint at step 2, its restore
    and steps 3 and 4 again: losses and state bit-equal; neither #10 nor
    its plain version runs (the encoder is non-causal, the decoder causal,
    both through ``sdpa_train``)."""
    monkeypatch.setattr(ref, "flash_attention",
                        lambda *a, **k: pytest.fail("training reached #10"))
    _, tcfg = _configs(ARCH)
    states, _ = reference_trajectory(1, ARCH)
    state = tloop.train_state_from_numpy(tcfg, states[0], device="cpu")
    step = tloop.make_train_step(tbuild_model(tcfg, device="cpu"),
                                 tloop.TrainConfig(microbatches=2))
    losses = []
    for i in range(4):
        if i == 2:
            ckpt.save_checkpoint(str(tmp_path), i, state)
        state, m = step(state, torch_batch(ARCH, i))
        losses.append(float(m["loss"]))
    again = ckpt.restore_checkpoint(
        str(tmp_path), 2, topt.tree_map(lambda t: t.to("meta"), state),
        device="cpu")
    replay = []
    for i in range(2, 4):
        again, m = step(again, torch_batch(ARCH, i))
        replay.append(float(m["loss"]))
    assert replay == losses[2:]
    for x, y in zip(topt.tree_leaves(state), topt.tree_leaves(again),
                    strict=True):
        assert torch.equal(x, y)
