"""Training the MoE configs on the port against the JAX package on the CPU:
reduced qwen3-moe-30b-a3b (8 experts, top-2, renormalised) and reduced
llama4-scout-17b-a16e (4 experts, top-1, a shared expert), fp32 compute,
the reference's state carried across as numpy arrays, one and two steps
at one and two microbatches against the reference's jitted
``make_train_step``.

Tolerances: those of tests/test_torch_train.py (``torch_train_parity``):
the loss and nll rtol 1e-5, ``aux_loss`` (the layers' summed
``e * sum(me * ce) * aux_loss_weight``) within 1e-6 of itself, the grad
and parameter norms rtol 1e-4, the moments and parameters by
``assert_state_close``.  The aux loss's gradient reaches the router
through the mean probabilities ``me`` only (the counts ``ce`` are
one-hot), as ``jax.grad`` sends it.

llama4-scout-17b-a16e's top-1 renormalised weight is p / p, exactly 1 with
derivative 0.  The port takes that derivative exactly (its weight is a
constant 1); the reference's autodiff of the division leaves a rounding
residue a token, which its routers' small aux-only gradient does not
dwarf.  Both are held to the reference's exact derivative
(``torch_train_parity.exact_route``, ``stop_gradient`` on that weight):
the port in ``test_train_steps_match_jax``, the reference's own autodiff
in ``test_reference_autodiff_meets_its_exact_derivative``, each under
the same rule.
"""

import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

from torch_train_parity import (_np, assert_state_close,
                                check_layout_reads_across,
                                check_steps_against_reference, exact_route,
                                reference_trajectory)

ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, mb):
    metrics = check_steps_against_reference(mb, arch, steps=2)
    assert all(m["aux_loss"] > 0 for m in metrics)


def test_reference_autodiff_meets_its_exact_derivative():
    """The reference's jitted step as it stands (autodiff through p / p)
    against the same step with that derivative exact (``exact_route``):
    llama4-scout-17b-a16e reduced, one microbatch, one and two steps, under
    ``assert_state_close``'s rule.  The division's residue is rounding and
    within GRAD_TOL; it shows in the routers' moments."""
    arch = "llama4-scout-17b-a16e"
    exact, metrics = reference_trajectory(1, arch)
    own, _ = reference_trajectory(1, arch, exact=False)
    lrs = [m["lr"] for m in metrics]
    for k in (1, 2):
        assert_state_close(own[k], exact[:k + 1], lrs[:k])
    mu_own, mu_exact = own[1].opt.mu["layers"], exact[1].opt.mu["layers"]
    assert not np.array_equal(_np(mu_own[1]["ffn"]["router"]),
                              _np(mu_exact[1]["ffn"]["router"]))


@pytest.mark.parametrize("cfg", [
    dict(num_experts=8, top_k=2, capacity_factor=1.0, group_tokens=16),
    dict(num_experts=4, top_k=1, capacity_factor=1.25, group_tokens=32,
         router_softmax_order="softmax_then_topk"),
    dict(num_experts=4, top_k=1, capacity_factor=1.25, group_tokens=32)])
def test_moe_layer_gradients_match_jax(cfg):
    """``apply_moe``'s output, aux loss and the gradients of a loss through
    both (capacity drops included at a capacity factor of 1) against
    ``jax.grad`` of the reference's, with the top-1 renormalised weight's
    derivative exact (``exact_route``; a no-op for the other routings):
    rtol 1e-5 on the values, gradients within 1e-5 of each one's largest
    (fp32 sums over d = 32 and the K experts of a token in another
    order)."""
    jc, tc = jmoe.MoEConfig(**cfg), tmoe.MoEConfig(**cfg)
    rng = np.random.default_rng(3)
    d, f, e = 32, 48, cfg["num_experts"]
    x = rng.normal(size=(2, 32, d)).astype(np.float32)
    params = {"router": rng.normal(size=(d, e)),
              "w_in": rng.normal(size=(e, d, f)) / np.sqrt(d),
              "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
              "w_out": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    weight = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(p, x, jc)
        return jnp.sum(y * weight) + 10.0 * aux, (y, aux)

    with unittest.mock.patch.object(jmoe, "route", exact_route(jmoe.route)):
        (jgp, jgx), (jy, jaux) = jax.jit(jax.grad(
            jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.apply_moe(tp, tx, tc)
    (torch.sum(ty * torch.from_numpy(weight)) + 10.0 * taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)
    for name, want in list(jgp.items()) + [("x", jgx)]:
        got = (tx if name == "x" else tp[name]).grad.numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, atol=1e-5 * float(np.abs(want).max()), err_msg=name)
    assert np.abs(tp["router"].grad.numpy()).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_checkpoint_reads_across_both_ways(arch, tmp_path):
    """The expert stacks, routers and shared expert round-trip through the
    port's checkpoint and the reference's, bit for bit."""
    check_layout_reads_across(arch, tmp_path)
