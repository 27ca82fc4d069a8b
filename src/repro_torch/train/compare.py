"""One training state against another's: the rule that the port's training
is held to, against the reference's trajectory on the CPU
(tests/torch_train_parity.py) and the card's step against the CPU's
(chip_smoke.py, tests/test_torch_gpu.py).

Both states are flattened by name (``checkpoint._flatten_with_names``)
and lie on one device.  ``grads[s]`` holds, for each parameter's name
suffix, |g| of step s as the second moments before and after it give it
(``step_grads``).  With ``grad_tol`` the share of a leaf's largest
gradient that two runs' gradients may differ by:

- the moments lie within ``grad_tol`` of the leaf's largest (mu is a sum
  of gradients, nu of their squares: twice that), plus ``floor``;
- a parameter within 1e-6 + 1e-5 of itself plus, for each step s, what a
  gradient error of ``grad_tol`` x the leaf's largest gradient can move
  AdamW's step m / (sqrt(v) + eps): at most 2 x lr_s x that error /
  (|g_s| + eps), capped at the step's own 2 x lr_s.  Only a gradient that
  is zero up to rounding gets more than the base tolerance, and then for
  its step only;
- a leaf whose every gradient is at most DEAD of the median leaf's
  largest (a key bias without RoPE, which the softmax cancels exactly, so
  both runs hold rounding only; the median, so that one leaf with an
  outsized gradient moves no other into this rule) has no largest
  gradient of its own to scale by: its moments on both sides must lie
  within DEAD of that median (nu its square), and its parameters get
  the cap, 2 x lr_s a step.
"""

from __future__ import annotations

import statistics

import torch
from torch import Tensor

DEAD = 1e-6          # of the median leaf's largest gradient
B2 = 0.95            # the reference's AdamW second-moment decay


def step_grads(nu_after: Tensor, nu_before: Tensor | None = None) -> Tensor:
    """|g| of one step from the second moments after it and before it
    (zero before the first step)."""
    v = nu_after if nu_before is None else nu_after - B2 * nu_before
    return (v.clamp_min(0.0) / (1.0 - B2)).sqrt()


def state_ratios(want: dict, got: dict, grads: list, lrs: list,
                 grad_tol: float, floor: float = 1e-12) -> dict:
    """``got`` against ``want`` after the steps with learning rates
    ``lrs``: the worst |diff| over its tolerance among the parameters and
    among the moments (each at most 1 where the states agree), the leaf of
    each, and the dead leaves' name suffixes."""
    assert set(got) == set(want) and len(grads) == len(lrs)
    tops = [statistics.median(float(g.max()) for g in gs.values())
            for gs in grads]
    dead_set = {x for x in grads[0]
                if all(float(gs[x].max()) <= DEAD * top
                       for gs, top in zip(grads, tops))}
    worst = {"params": (0.0, None), "moments": (0.0, None)}

    def note(kind, ratio, name):
        if ratio > worst[kind][0]:
            worst[kind] = (ratio, name)

    for name, w in want.items():
        g = got[name]
        if name.startswith(".opt.step"):
            assert int(g) == int(w), (name, int(g), int(w))
            continue
        if name.startswith((".opt.mu", ".opt.nu")):
            nu = name.startswith(".opt.nu")
            if name[len(".opt.mu"):] in dead_set:
                bound = DEAD * max(tops)
                note("moments", float(torch.maximum(g.abs().max(),
                                                    w.abs().max()))
                     / (bound * bound if nu else bound), name)
                continue
            tol = ((2.0 if nu else 1.0) * grad_tol * float(w.abs().max())
                   + floor)
            note("moments", float((g - w).abs().max()) / tol, name)
            continue
        suffix = name[len(".params"):]
        tol = 1e-6 + 1e-5 * w.abs()
        for gs, lr in zip(grads, lrs):
            cap = (2.0 if suffix in dead_set else torch.clamp(
                2.0 * grad_tol * float(gs[suffix].max())
                / (gs[suffix] + 1e-8), max=2.0))
            tol = tol + lr * cap
        note("params", float(((g - w).abs() / tol).max()), name)
        del tol
    return {"params_diff_over_tol": worst["params"][0],
            "params_worst": worst["params"][1],
            "moments_diff_over_tol": worst["moments"][0],
            "moments_worst": worst["moments"][1],
            "dead": dead_set}
