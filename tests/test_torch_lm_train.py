"""The port's LM training step against the JAX reference, on the CPU.

The attention archs here, the MoE and state-mixer ones in
``test_torch_lm_train_moe.py`` (``tests/_lm_parity.py``'s ``train_run``
for both): every registered arch at ``reduced()`` size, from one
``TrainState`` carried across by ``interop.from_jax_train_state`` (weights
from the reference's seed, zero moments), on batches made from a numpy
seed (48 tokens: past the reduced sliding window of 32, three chunks of
the Mamba and RWKV6 scans); the MoE archs at capacity factor 2 x E / k,
where no token drops.  The reference's step runs jitted, as its launcher
runs it.

  * the first step's ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``
    within 1e-5 x max(1, |ref|);
  * every gradient leaf of ``loss_fn`` (the port's backward against
    ``jax.grad``) within 1e-5 x max(1, max|g_ref|);
  * m and v after 3 steps within 1e-5 x max(1, max|ref|), and the params
    within that plus 2 x lr_s for each step s at which the element's
    reference gradient lies within the gradient tolerance of zero: Adam's
    first steps move an element by about lr whatever its grad's size, so
    where a grad near zero has the other sign in the two packages, that
    element moves the other way, 2 x lr apart after one step.  Every
    other element has no lr term, so an update that is missing, of the
    wrong sign or of the wrong size fails.

Then the train state's interop, a step that raises after its backward
(the state stays as it was, and the loop goes on from it), a rollback of a
train state and the launcher's ``--arch`` path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (cfgs, check_first_step, check_grads, check_state,
                        quiet_logging, train_run)
from repro.models import lm as jx_lm
from repro.models import transformer as jx_transformer
from repro.optim import adam as jx_adam
from repro_torch.checkpoint import Checkpointer
from repro_torch.config import get_arch, reduced
from repro_torch.data.synthetic import token_batches
from repro_torch.interop import from_jax_train_state, to_numpy_train_state
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.optim import adam
from repro_torch.runtime.fault_tolerance import LoopConfig, ResilientLoop

# the attention archs; the MoE and state-mixer ones are in
# test_torch_lm_train_moe.py
ARCHS = ["qwen2.5-3b", "gemma3-4b", "gemma3-27b", "command-r-35b",
         "pixtral-12b", "hubert-xlarge"]


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


def test_train_state_interop_round_trips_bit_for_bit():
    jcfg, cfg = cfgs("jamba-v0.1-52b")
    jp = jax.jit(jx_transformer.init_params, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(0)
    st = jx_lm.TrainState(jp, jx_adam.AdamState(
        jnp.asarray(7, jnp.int32),
        jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                           a.dtype), jp),
        jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), a.dtype),
                     jp)))
    np_state = jax.tree.map(np.asarray, st)
    state = from_jax_train_state(np_state, cfg, device="cpu")
    assert isinstance(state, lm.TrainState)
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 7
    assert list(state.opt.m) == [n for n, _ in
                                 state.params.named_parameters()]
    back = to_numpy_train_state(state, cfg)
    want = (np_state.params, (np_state.opt.step, np_state.opt.m,
                              np_state.opt.v))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- failures, the loop and the launcher -----------------------------------------

def _small(seed=0):
    cfg = reduced(get_arch("qwen2.5-3b"))
    state = lm.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b, _ in zip(token_batches(cfg.vocab_size, 2, 16, seed=0),
                               range(6))]
    return cfg, state, batches


def _snapshot(state):
    return [t.detach().clone() for t in
            [p for _, p in state.params.named_parameters()]
            + [state.opt.step] + list(state.opt.m.values())
            + list(state.opt.v.values())]


def _equal(state, snap):
    return all(torch.equal(a, b) for a, b in zip(_snapshot(state), snap))


def test_step_that_raises_after_its_backward_leaves_the_state(monkeypatch):
    cfg, state, batches = _small()
    snap = _snapshot(state)
    seen = {}
    clip = adam.clip_by_global_norm

    def failing_clip(grads, max_norm):
        # the backward is done: every grad is here
        seen["grads"] = len(grads)
        assert all(torch.isfinite(g).all() for g in grads.values())
        raise RuntimeError("simulated device fault after the backward")

    monkeypatch.setattr(adam, "clip_by_global_norm", failing_clip)
    step = lm.make_train_step(cfg)
    with pytest.raises(RuntimeError, match="after the backward"):
        step(state, batches[0])
    assert seen["grads"] == len(list(state.params.parameters()))
    assert _equal(state, snap)
    # the loop goes on from the same state (no checkpoint yet), as the
    # reference's does: the run equals the one without the failed batch
    monkeypatch.setattr(adam, "clip_by_global_norm", clip)
    calls = {"n": 0}

    def flaky(st, b):
        calls["n"] += 1
        if calls["n"] == 2:
            monkeypatch.setattr(adam, "clip_by_global_norm", failing_clip)
            try:
                return step(st, b)
            finally:
                monkeypatch.setattr(adam, "clip_by_global_norm", clip)
        return step(st, b)

    class NoCheckpoints:
        def latest_step(self):
            return None

        def save(self, *a, **k):
            pass

    loop = ResilientLoop(flaky, NoCheckpoints(), LoopConfig(
        checkpoint_every=100, max_steps=3))
    loop.run(state, iter(batches))
    assert len(loop.stats.failures) == 1 and loop.stats.steps_done == 3
    _, want, _ = _small()
    for b in (batches[0], batches[2], batches[3]):
        step(want, b)
    assert _equal(state, _snapshot(want))


def test_checkpoint_rollback_of_a_train_state(tmp_path):
    """A train state saved, trained on in place, restored in place: its
    own tensors hold the saved bits again."""
    cfg, state, batches = _small()
    ck = Checkpointer(str(tmp_path), keep=2)
    step = lm.make_train_step(cfg)
    step(state, batches[0])
    ck.save(1, state, blocking=True)
    snap = _snapshot(state)
    ptrs = [t.data_ptr() for t in _snapshot_refs(state)]
    step(state, batches[1])
    assert not _equal(state, snap)
    assert ck.restore(1, state) is state
    assert _equal(state, snap)
    assert [t.data_ptr() for t in _snapshot_refs(state)] == ptrs


def _snapshot_refs(state):
    return ([p for _, p in state.params.named_parameters()]
            + [state.opt.step] + list(state.opt.m.values())
            + list(state.opt.v.values()))


def test_launcher_arch_path_equals_the_raw_loop_and_resumes(
        tmp_path, quiet_logging):
    argv = ["--arch", "qwen2.5-3b", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "2", "--log-level", "error"]
    r = train_launcher.main(argv)
    cfg = reduced(get_arch("qwen2.5-3b"))
    state = lm.init_train_state(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    step = lm.make_train_step(cfg, total_steps=3)
    want = []
    for b, _ in zip(token_batches(cfg.vocab_size, 2, 16, seed=0), range(3)):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        want.append(float(m["loss"]))
    assert r["losses"] == want
    assert r["resumed_from"] is None and r["failures"] == []
    assert r["steps_done"] == 3 and r["median_step_ms"] > 0
    assert r["tokens_per_s"] > 0 and r["peak_memory_bytes"] is None
    assert r["save_seconds"] > 0 and r["save_bytes"] > 0
    assert sorted(Checkpointer(str(tmp_path)).all_steps()) == [2, 3]
    # a second call on the directory resumes from its last checkpoint
    r2 = train_launcher.main(argv[:5] + ["5"] + argv[6:])
    assert r2["resumed_from"] == 3 and r2["steps_done"] == 2
    assert len(r2["losses"]) == 2 and np.isfinite(r2["losses"]).all()


def test_launcher_arch_refuses_mesh_and_keeps_snn_defaults(quiet_logging,
                                                          tmp_path):
    """``--arch`` refuses the SNN's ``data=2`` mesh form and runs the DxM
    one (data 1 x model 2: two gloo processes); the SNN keeps its
    defaults."""
    with pytest.raises(ValueError, match="DxM"):
        train_launcher.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                             "--mesh", "data=2", "--log-level", "error"])
    r = train_launcher.main(["--arch", "qwen2.5-3b", "--device", "cpu",
                             "--mesh", "1x2", "--steps", "1", "--batch", "2",
                             "--seq", "8", "--ckpt-dir", str(tmp_path),
                             "--log-level", "error"])
    assert r["mesh"] == "1x2" and r["profile"] == "tp_fsdp"
    assert r["steps_done"] == 1 and np.isfinite(r["losses"]).all()
    r = train_launcher.main(["--device", "cpu", "--steps", "1", "--batch",
                             "4", "--log-level", "error"])
    assert r["batch"] == 4 and len(r["losses"]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init_train_state(torch.Generator(),
                                reduced(get_arch("qwen2.5-3b")))
