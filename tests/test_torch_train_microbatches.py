"""The port's train step with two microbatches against the JAX package's
on the CPU (reduced starcoder2-3b, fp32 compute, the reference's state
carried across as numpy arrays): one and three steps, the gradients of
the two halves added in fp32 and divided by two, the metrics averaged, as
the reference's loop does; and the same step of one microbatch, which
differs from it only by the sums' order.  Tolerances: those of
tests/test_torch_train.py (``torch_train_parity.assert_state_close``);
one microbatch against two: loss rtol 1e-5, parameters as
``assert_state_close`` holds them.
"""

import numpy as np
import pytest

from torch_train_parity import (_configs, assert_state_close,
                                check_steps_against_reference, port_steps,
                                reference_trajectory)


@pytest.mark.parametrize("mb", [2])
def test_train_steps_match_jax(mb):
    check_steps_against_reference(mb)


def test_two_microbatches_equal_one_up_to_the_order_of_sums():
    _, tcfg = _configs()
    states, ref_metrics = reference_trajectory(2)
    one, m1 = port_steps(tcfg, states[0], 0, 1, 1)
    two, m2 = port_steps(tcfg, states[0], 0, 1, 2)
    np.testing.assert_allclose(m1[0]["loss"], m2[0]["loss"], rtol=1e-5)
    assert_state_close(one, states[:2], [ref_metrics[0]["lr"]])
    assert_state_close(two, states[:2], [ref_metrics[0]["lr"]])
