"""The port's LM training step against the JAX reference on the CPU: the
MoE and state-mixer archs (deepseek-moe-16b, deepseek-v3-671b with MLA,
jamba-v0.1-52b with Mamba, rwkv6-7b), as ``test_torch_lm_train.py`` holds
the attention archs, with the same run (``tests/_lm_parity.py``'s
``train_run``) and bounds: the first step's metrics and every gradient
leaf of ``loss_fn`` within 1e-5 x max(1, max|ref|), m and v after 3 steps
within that, and the params within that plus 2 x the lr of each step at
which the element's reference gradient lies within the gradient
tolerance of zero.

The MoE archs run at capacity factor 2 x E / k, where no token drops, and
their routing is compared choice for choice before every step.  A choice
may differ only at a float32 tie of the k-th gate (margin under
``TIE_MARGIN``, 1e-6): which of two equal gates wins is the packages'
rounding, not their routing.  From such a step on the two train on
different choices, so the port's state is held to the reference's there
and carried across again (reduced jamba can meet one such tie at its
second step: a token of its last MoE layer whose 2nd and 3rd gates are
equal in float32).  One deepseek-moe-16b case runs at its configured capacity
factor 1.25, where tokens drop: its routing equals the reference's choice
for choice, each assert printing the smallest k-th gate margin.
"""
import numpy as np
import pytest

from _lm_parity import (TIE_MARGIN, check_first_step, check_grads,
                        check_state, train_run, within)

ARCHS = ["deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
         "rwkv6-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_metrics_match_reference(arch):
    check_first_step(train_run(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_match_jax_grad(arch):
    check_grads(train_run(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_after_three_steps_matches_reference(arch):
    r = train_run(arch)
    check_state(r["state"], r["ref_state"], r["lrs"], r["step_grads"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_routing_differs_only_at_ties(arch):
    """The first step's routing is the reference's choice for choice; a
    later step's only at a float32 tie of the k-th gate."""
    r = train_run(arch)
    assert r["routes"] and len(r["routes"]) == len(r["ref_routes"])
    for step, flips in r["flips"]:
        assert step > 0, flips
        for call, tok, margin in flips:
            assert margin < TIE_MARGIN, (step, call, tok, margin)


def test_dropping_moe_routes_and_steps_match_reference():
    """deepseek-moe-16b at its configured capacity factor 1.25: tokens
    drop, the routing equals the reference's choice for choice, and the
    step agrees as in the no-drop cases."""
    r = train_run("deepseek-moe-16b", drop=True)
    assert r["cfg"].moe.capacity_factor == 1.25
    assert not r["flips"]
    routes, ref = r["routes"], r["ref_routes"]
    assert len(routes) == len(ref) == 2
    dropped = 0
    for got, (ti, pos, cap) in zip(routes, ref):
        margin = got["margin"]
        assert np.array_equal(got["top_idx"].numpy(), ti), \
            f"top_idx differs; smallest k-th gate margin {margin:.3e}"
        assert np.array_equal(got["pos"].numpy(), pos), \
            f"positions differ; smallest k-th gate margin {margin:.3e}"
        assert np.array_equal(got["keep"].numpy(), pos < cap), \
            f"keep differs; smallest k-th gate margin {margin:.3e}"
        dropped += int((~got["keep"]).sum())
    assert dropped > 0, "this case is to drop tokens"
    check_first_step(r)
    check_grads(r)
    check_state(r["state"], r["ref_state"], r["lrs"], r["step_grads"])
    within(r["metrics"]["aux"], r["ref_metrics"]["aux"])
