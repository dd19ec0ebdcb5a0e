"""The port's LM configs and counts against the reference's, and the
guards of the LM slice: an unknown layer kind raises, ``shard_logical``
raises under a sharding context, the entry points default to the card.

Configs and ``reduced`` equal field for field for all 10 archs;
``count_params`` and ``step_flops`` equal exactly for every (arch x
``LM_SHAPES``), at full size and reduced; every arch's full-width model
built on the ``meta`` device (no storage) holds exactly ``count_params``
parameters.
Neither side needs JAX here: ``repro.config`` and
``repro.models.counting`` import none.
"""
import dataclasses

import pytest
import torch

from repro import config as jx_config
from repro.models import counting as jx_counting
from repro_torch import config
from repro_torch.models import counting, transformer
from repro_torch.models.layers import embedding
from repro_torch.sharding import ShardingCtx, shard_logical, use_sharding

ARCHS = sorted(jx_config.list_archs())


def _as_dict(cfg):
    return {"type": type(cfg).__name__, **dataclasses.asdict(cfg)}


def test_registry_lists_the_reference_archs():
    assert list(config.list_archs()) == ARCHS
    assert ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_fields_and_pattern_match_reference(arch):
    got, want = config.get_arch(arch), jx_config.get_arch(arch)
    assert _as_dict(got) == _as_dict(want)
    assert got.stage_list() == want.stage_list()
    assert got.pattern() == want.pattern()


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_matches_reference(arch):
    got = config.reduced(config.get_arch(arch))
    want = jx_config.reduced(jx_config.get_arch(arch))
    assert _as_dict(got) == _as_dict(want)
    assert got.pattern() == want.pattern()
    over = dict(d_model=32, d_ff=48, vocab_size=100, norm_eps=1e-5)
    assert _as_dict(config.reduced(config.get_arch(arch), **over)) == \
        _as_dict(jx_config.reduced(jx_config.get_arch(arch), **over))


def test_lm_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in config.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jx_config.LM_SHAPES]
    assert sorted(config.SHAPES_BY_NAME) == sorted(jx_config.SHAPES_BY_NAME)
    for kind in ("ATTN_FULL", "ATTN_SLIDING", "ATTN_MLA", "MAMBA", "RWKV6",
                 "FFN_DENSE", "FFN_MOE"):
        assert getattr(config, kind) == getattr(jx_config, kind)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_exact(arch, size):
    got, want = config.get_arch(arch), jx_config.get_arch(arch)
    if size == "reduced":
        got, want = config.reduced(got), jx_config.reduced(want)
    for active in (False, True):
        assert counting.count_params(got, active_only=active) == \
            jx_counting.count_params(want, active_only=active)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("shape", [s.name for s in jx_config.LM_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_exact(arch, shape):
    got = counting.step_flops(config.get_arch(arch),
                              config.SHAPES_BY_NAME[shape])
    want = jx_counting.step_flops(jx_config.get_arch(arch),
                                  jx_config.SHAPES_BY_NAME[shape])
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_model_holds_count_params(arch):
    """The model at its published widths and depth, on the meta device:
    every layer built, no storage, exactly the closed-form count."""
    cfg = config.get_arch(arch)
    model = transformer.Transformer(cfg, device="meta")
    assert len(model.layers) == cfg.num_layers
    assert sum(p.numel() for p in model.parameters()) == \
        counting.count_params(cfg)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_an_unknown_layer_kind_raises():
    base = config.reduced(config.get_arch("qwen2.5-3b"))
    for kinds in (("lstm", config.FFN_DENSE), (config.MAMBA, "glu")):
        cfg = dataclasses.replace(base, stages=((1, (kinds,)),),
                                  num_layers=1)
        with pytest.raises(ValueError, match="unknown layer kind"):
            transformer.Transformer(cfg, device="meta")
        with pytest.raises(ValueError, match="unknown layer kind"):
            transformer.init_caches(cfg, 1, 8, device="cpu")


def test_shard_logical_is_identity_without_a_context():
    x = torch.ones(2, 3)
    assert shard_logical(x, ("batch", None)) is x


def test_shard_logical_raises_under_a_context():
    cfg = config.reduced(config.get_arch("qwen2.5-3b"))
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with use_sharding(ShardingCtx((("data", 1),))):
        # a plain tensor under a context: an activation that would skip
        # the sharding; the message names this call site
        with pytest.raises(TypeError, match=r"test_torch_lm_config\.py:\d+: "
                           r"a plain Tensor under a ShardingCtx"):
            shard_logical(torch.ones(2), ("batch",))
        # a context on a mesh description has no placements to lay the
        # LM's inputs out by
        with pytest.raises(TypeError, match="not a torch DeviceMesh"):
            embedding.embed(model.embed, cfg, tokens=tokens)
        with pytest.raises(TypeError, match="not a torch DeviceMesh"):
            transformer.forward(model, cfg, tokens=tokens)
    transformer.forward(model, cfg, tokens=tokens)


def test_entry_points_default_to_the_card(monkeypatch):
    """No device means the card: on a host without one, the weights and
    the caches raise instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.reduced(config.get_arch("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_caches(cfg, 1, 8)
    with pytest.raises(ValueError, match="generator lives on"):
        transformer.init_params(torch.Generator(), cfg, device="meta")
