"""The public surface of the port's facade, ``repro_torch.api``: its
``__all__`` matches the reference's and resolves, the spec vocabulary
matches the layers underneath, and the deprecation shims on the old
kwarg-threaded signatures keep working while warning exactly once per
process.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import repro.api as jx_api
import repro_torch.api as api
from repro_torch.api._compat import reset_deprecation_warnings


def test_all_matches_the_reference_and_resolves():
    assert api.__all__ == jx_api.__all__
    missing = [name for name in api.__all__ if not hasattr(api, name)]
    assert not missing, missing
    assert api.ExecutionSpec() and api.TrainSpec() and api.ServeSpec()
    assert api.SCHEDULE_MODES == jx_api.SCHEDULE_MODES


def test_spec_vocabulary_matches_lower_layers():
    from repro_torch.core.snn_model import SNN_BACKENDS
    from repro_torch.core.surrogate import SURROGATE_KINDS
    for b in SNN_BACKENDS:
        assert api.ExecutionSpec(backend=b)
    for k in SURROGATE_KINDS:
        assert api.ExecutionSpec(surrogate_kind=k)
    for m in api.SCHEDULE_MODES:
        spec = api.ExecutionSpec(backend="hopper", schedule_mode=m)
        assert spec.resolved_schedule() in (None, "cbws", "aprc+cbws")


def test_dist_mesh_helpers_match_the_reference():
    from repro.dist import mesh as jx_mesh
    from repro_torch.dist import mesh_str, normalize_mesh, parse_mesh
    for text in ("4", "data=4", "data=2,model=2", " data = 2 "):
        assert parse_mesh(text) == jx_mesh.parse_mesh(text)
        assert mesh_str(parse_mesh(text)) == jx_mesh.mesh_str(
            jx_mesh.parse_mesh(text))
    for form in ({"data": 2, "model": 2}, [["data", 4]], None):
        assert normalize_mesh(form) == jx_mesh.normalize_mesh(form)
    for bad in ("", "data", "data=x", "data=0"):
        with pytest.raises(ValueError):
            jx_mesh.parse_mesh(bad)
        with pytest.raises(ValueError):
            parse_mesh(bad)
    for bad in ([("data", 2), ("data", 2)], [("", 2)], [("data", True)], []):
        with pytest.raises(ValueError):
            normalize_mesh(bad)


@pytest.fixture()
def fresh_shim_registry():
    reset_deprecation_warnings()
    yield
    reset_deprecation_warnings()


def _tiny():
    from repro_torch.config import get_snn
    from repro_torch.core.snn_model import init_snn
    cfg = dataclasses.replace(
        get_snn("snn-mnist"), input_hw=(8, 8), conv_channels=(8, 8),
        timesteps=2, num_spe_clusters=4)
    return cfg, init_snn(torch.Generator().manual_seed(0), cfg, device="cpu")


def _deprecations(rec, word):
    return [w for w in rec if issubclass(w.category, DeprecationWarning)
            and word in str(w.message)]


def test_serve_frames_shim_warns_exactly_once(fresh_shim_registry):
    from repro_torch.serving import serve_frames
    cfg, params = _tiny()
    frames = np.full((2, 8, 8, 1), 0.5, np.float32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s1 = serve_frames(params, cfg, frames, backend="batched", steps=1,
                          device="cpu")
        s2 = serve_frames(params, cfg, frames, backend="hopper",
                          schedule_mode="aprc+cbws", steps=1, device="cpu")
    assert len(_deprecations(rec, "serve_frames")) == 1
    assert s1["frames"] == 2 and np.isfinite(s2["fps"])
    np.testing.assert_allclose(s1["outputs"].logits, s2["outputs"].logits,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", ["batched", "hopper"])
def test_make_train_step_legacy_kwargs_warn_once_and_match_spec(
        fresh_shim_registry, backend):
    from repro_torch.core.snn_train import make_train_step
    cfg, params = _tiny()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (4, 8, 8, 1), dtype=np.float32))
    y = torch.tensor([0, 3, 5, 9])
    mom = tree_map(torch.zeros_like, params)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        legacy = make_train_step(cfg, backend=backend, lr=1e-2)
        make_train_step(cfg, backend=backend)         # second legacy call
    assert len(_deprecations(rec, "make_train_step")) == 1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        specced = make_train_step(
            cfg, spec=api.TrainSpec(backend=backend, lr=1e-2))
    assert not _deprecations(rec, ""), "spec-driven calls must not warn"
    p1, m1, l1 = legacy(params, mom, x, y)
    p2, m2, l2 = specced(params, mom, x, y)
    assert torch.equal(l1, l2)
    for a, b in zip(*(torch.utils._pytree.tree_leaves(t)
                      for t in (p1, p2))):
        assert torch.equal(a, b)


def test_loss_and_rows_legacy_kwargs_warn_once(fresh_shim_registry):
    from repro_torch.core.snn_train import make_grad_rows_fn, make_loss_fn
    cfg, _ = _tiny()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(2):
            make_loss_fn(cfg, backend="batched")
            make_grad_rows_fn(cfg, surrogate_alpha=4.0)
        make_loss_fn(cfg, spec=api.TrainSpec())
    assert len(_deprecations(rec, "make_loss_fn")) == 1
    assert len(_deprecations(rec, "make_grad_rows_fn")) == 1


def test_make_train_step_rejects_spec_plus_legacy_kwargs():
    from repro_torch.core.snn_train import make_train_step
    cfg, _ = _tiny()
    with pytest.raises(ValueError, match="not both"):
        make_train_step(cfg, backend="batched",
                        spec=api.TrainSpec(backend="ref"))
