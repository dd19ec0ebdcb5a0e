"""The port's training runtime on the CPU: ``Checkpointer``,
``ResilientLoop`` and ``Prefetcher``, against the JAX reference where the
two meet.

The reference's own cases (``tests/test_checkpoint.py``,
``tests/test_runtime.py``'s loop tests, ``test_misc_substrate.py``'s
prefetcher test) run on the port; a directory written by either package
restores in the other bit for bit, on the reference's test tree (a nested
dict, a list, int32 and bfloat16 leaves), with no ``ml_dtypes`` on the
port's side; ``restore`` writes into the target's own tensors.
"""
import itertools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JxCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import Prefetcher, global_batch_iterator
from repro_torch.optim.adam import AdamState
from repro_torch.runtime.fault_tolerance import LoopConfig, ResilientLoop
from repro_torch.tree import flatten_with_paths


def _jx_tree(key):
    """The reference's test tree (``tests/test_checkpoint.py``)."""
    return {
        "a": jax.random.normal(key, (4, 8)),
        "nested": {"b": jnp.arange(6, dtype=jnp.int32),
                   "c": jax.random.normal(key, (3,)).astype(jnp.bfloat16)},
        "scalars": [jnp.asarray(3), jnp.asarray(2.5)],
    }


def _bits(a) -> np.ndarray:
    """A leaf's bits as numpy (bfloat16 as its 16-bit pattern)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_torch(jtree):
    """The reference's tree as torch tensors, bits kept."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, jtree)


def _zeros_like(ttree):
    return jax.tree.map(torch.zeros_like, ttree)


def _tree(seed=0):
    return _to_torch(_jx_tree(jax.random.PRNGKey(seed)))


# -- the reference's four cases, on the port -----------------------------------

def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ck.save(10, tree, blocking=True)
    target = _zeros_like(tree)
    ptrs = [t.data_ptr() for t in jax.tree.leaves(target)]
    out = ck.restore(10, target)
    assert out is target
    assert [t.data_ptr() for t in jax.tree.leaves(out)] == ptrs
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(out)):
        assert a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


def test_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_restore_latest_after_crash_mid_save(tmp_path):
    """A stray .tmp dir (simulated crash) must not be visible as a step."""
    ck = Checkpointer(str(tmp_path), keep=3)
    tree = {"x": torch.ones((2,))}
    ck.save(5, tree, blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_6.tmp"))
    assert ck.latest_step() == 5


def test_async_save_completes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.full((16, 16), 7.0)}
    ck.save(1, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


# -- the port's own contracts ----------------------------------------------------

def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """The state is written in place after ``save`` returns: the files hold
    the values at the call, even while the write is in flight."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(1 << 16, dtype=torch.float32)
    ck.save(1, {"x": x})
    x.add_(1.0)
    ck.wait()
    out = ck.restore(1, {"x": torch.empty_like(x)})
    assert torch.equal(out["x"], torch.arange(1 << 16, dtype=torch.float32))
    assert ck.last_save_bytes == x.nbytes


def test_a_failed_write_is_raised_by_wait_and_the_next_save(tmp_path):
    """A write that fails in the thread (here: ``step_5.tmp`` is a file,
    so its directory cannot be made) is raised by ``wait``, once; a
    non-blocking save's failure is raised by the next ``save``, which
    then writes nothing; a blocking save raises it itself."""
    ck = Checkpointer(str(tmp_path))
    tree = {"x": torch.arange(8, dtype=torch.float32)}
    (tmp_path / "step_5.tmp").write_text("")
    ck.save(5, tree)
    with pytest.raises(RuntimeError, match="failed") as e:
        ck.wait()
    assert isinstance(e.value.__cause__, OSError)
    ck.wait()                          # raised once
    assert ck.all_steps() == []
    ck.save(5, tree)
    with pytest.raises(RuntimeError, match="failed"):
        ck.save(6, tree)
    assert ck.all_steps() == []
    with pytest.raises(RuntimeError, match="failed"):
        ck.save(5, tree, blocking=True)
    ck.save(6, tree, blocking=True)
    assert ck.all_steps() == [6]


def test_paths_of_named_tuples_modules_and_dicts(tmp_path):
    """The reference's path form: a NamedTuple's field is ``.name``, a
    dict key its string (sorted), a list its index, a module its
    parameter names split at their dots."""
    model = torch.nn.Sequential(torch.nn.Linear(2, 3))
    state = (model, AdamState(torch.zeros((), dtype=torch.int32),
                              {"0.weight": torch.zeros(3, 2)},
                              {"0.weight": torch.ones(3, 2)}))
    assert list(flatten_with_paths(state)) == [
        "0/0/weight", "0/0/bias", "1/.step", "1/.m/0.weight",
        "1/.v/0.weight"]
    assert list(flatten_with_paths({"b": [1], "a": {"d": 2, "c": 3}})) == [
        "a/c", "a/d", "b/0"]
    # joined by dots, a module's paths are its parameter names
    assert list(flatten_with_paths({"m": model}, ".")) == [
        "m.0.weight", "m.0.bias"]
    with pytest.raises(TypeError, match="not a tensor"):
        Checkpointer(str(tmp_path)).save(1, {"x": np.zeros(2)})
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, blocking=True)
    target = (torch.nn.Sequential(torch.nn.Linear(2, 3)),
              AdamState(torch.ones((), dtype=torch.int32),
                        {"0.weight": torch.ones(3, 2)},
                        {"0.weight": torch.zeros(3, 2)}))
    ck.restore(3, target)
    assert torch.equal(target[0][0].weight, model[0].weight)
    assert int(target[1].step) == 0
    assert float(target[1].m["0.weight"].sum()) == 0.0
    with open(tmp_path / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 3
    assert manifest["leaves"]["1/.step"] == {"shape": [], "dtype": "int32"}


def test_restore_refuses_another_shape(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros(3)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"x": torch.zeros(4)})


# -- across the two packages -----------------------------------------------------

def test_reference_directory_restores_in_the_port(tmp_path):
    jtree = _jx_tree(jax.random.PRNGKey(1))
    JxCheckpointer(str(tmp_path), keep=2).save(4, jtree, blocking=True)
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() == 4
    target = _zeros_like(_to_torch(jtree))
    ck.restore(4, target)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(target)):
        assert np.array_equal(_bits(a), _bits(b))
    assert target["nested"]["c"].dtype == torch.bfloat16


def test_port_directory_restores_in_the_reference(tmp_path):
    jtree = _jx_tree(jax.random.PRNGKey(2))
    Checkpointer(str(tmp_path), keep=2).save(7, _to_torch(jtree),
                                             blocking=True)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jtree)
    out = JxCheckpointer(str(tmp_path), keep=2).restore(7, like)
    assert jax.tree.structure(out) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(out)):
        assert np.asarray(b).dtype == a.dtype
        assert np.array_equal(_bits(a), _bits(b))
    # the two packages write the same manifest
    JxCheckpointer(str(tmp_path / "ref"), keep=2).save(7, jtree,
                                                       blocking=True)
    with open(tmp_path / "step_7" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_7" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine == theirs


def test_bfloat16_restore_needs_no_ml_dtypes(tmp_path):
    """The port reads bfloat16 back through ``torch.Tensor.view``; a
    process where ``ml_dtypes`` cannot be imported restores it."""
    jtree = _jx_tree(jax.random.PRNGKey(3))
    JxCheckpointer(str(tmp_path), keep=2).save(2, jtree, blocking=True)
    want = np.asarray(jtree["nested"]["c"]).view(np.int16).tolist()
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None       # import ml_dtypes raises
        import torch
        from repro_torch.checkpoint import Checkpointer
        t = {{"a": torch.zeros(4, 8), "scalars": [torch.zeros((),
              dtype=torch.int32), torch.zeros(())],
             "nested": {{"b": torch.zeros(6, dtype=torch.int32),
                        "c": torch.zeros(3, dtype=torch.bfloat16)}}}}
        Checkpointer({str(tmp_path)!r}).restore(2, t)
        assert "jax" not in sys.modules
        print(t["nested"]["c"].view(torch.int16).tolist())
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip()) == want


# -- ResilientLoop: the reference's four cases (tests/test_runtime.py) -----------

def _batches():
    return itertools.repeat({"x": 1.0})


def test_loop_runs_and_checkpoints(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)

    def step(state, batch):
        return {"w": state["w"] + 1.0}, {"loss": float(state["w"])}

    loop = ResilientLoop(step, ck, LoopConfig(checkpoint_every=3,
                                              max_steps=10))
    out = loop.run({"w": torch.zeros(())}, _batches())
    assert float(out["w"]) == 10.0
    ck.wait()
    assert 10 in ck.all_steps()


def test_loop_recovers_from_transient_failure(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    fail_at = {7}

    def step(state, batch):
        s = int(state["w"])
        if s + 1 in fail_at:
            fail_at.clear()           # transient: fails once
            raise RuntimeError("simulated preemption")
        return {"w": state["w"] + 1.0}, {}

    loop = ResilientLoop(step, ck, LoopConfig(checkpoint_every=2,
                                              max_steps=10))
    out = loop.run({"w": torch.zeros(())}, _batches())
    assert float(out["w"]) == 10.0
    assert len(loop.stats.failures) == 1


def test_loop_escalates_after_budget(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)

    def step(state, batch):
        raise RuntimeError("hard failure")

    loop = ResilientLoop(step, ck, LoopConfig(checkpoint_every=2,
                                              max_steps=10, max_failures=2))
    with pytest.raises(RuntimeError, match="failure budget"):
        loop.run({"w": torch.zeros(())}, _batches())


def test_loop_resumes_from_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)

    def step(state, batch):
        return {"w": state["w"] + 1.0}, {}

    loop = ResilientLoop(step, ck, LoopConfig(checkpoint_every=2,
                                              max_steps=6))
    loop.run({"w": torch.zeros(())}, _batches())
    ck.wait()
    # "restart the job": fresh loop resumes at step 6, runs to 9
    loop2 = ResilientLoop(step, ck, LoopConfig(checkpoint_every=2,
                                               max_steps=9))
    out = loop2.run({"w": torch.zeros(())}, _batches())
    assert loop2.stats.resumed_from == 6
    assert float(out["w"]) == 9.0


def test_loop_rolls_back_an_in_place_state(tmp_path):
    """A step that writes its state in place and raises at step 5 rolls
    back into the same tensor and replays to the end: to checkpoint 4, or
    to 2 when step 4's async save is still being written (the loop reads
    the latest finished step, as the reference's does)."""
    ck = Checkpointer(str(tmp_path), keep=5)
    fail_at = {5}
    w = torch.zeros(3)

    def step(state, batch):
        if int(state["w"][0]) + 1 in fail_at:
            fail_at.clear()
            raise RuntimeError("simulated preemption")
        state["w"].add_(1.0)
        return state, {}

    loop = ResilientLoop(step, ck, LoopConfig(checkpoint_every=2,
                                              max_steps=8))
    out = loop.run({"w": w}, _batches())
    assert out["w"] is w and torch.equal(w, torch.full((3,), 8.0))
    assert loop.stats.failures[0][0] == 4
    assert loop.stats.steps_done in (8, 10)


# -- Prefetcher ------------------------------------------------------------------

def test_prefetcher_orders_and_stops():
    def gen():
        for i in range(5):
            yield {"i": np.asarray(i)}
    pf = Prefetcher(gen(), depth=2)
    got = [int(b["i"]) for b in pf]
    assert got == [0, 1, 2, 3, 4]


def test_prefetcher_places_batches_and_surfaces_errors():
    def gen():
        yield {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)}
        raise ValueError("source broke")
    pf = global_batch_iterator(lambda seed: gen(), device="cpu")
    b = next(pf)
    assert isinstance(b["tokens"], torch.Tensor)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type == \
        "cpu"
    with pytest.raises(ValueError, match="source broke"):
        next(pf)
    # an endless source stops on close
    endless = Prefetcher(itertools.repeat({"x": np.zeros(2)}), depth=2)
    next(endless)
    endless.close()
    assert not endless._thread.is_alive()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Prefetcher(iter([]), device="cuda")
