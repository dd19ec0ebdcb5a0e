"""The language-model family on the CPU: the plain reference against the
port's ``transformer.forward`` on the benchmark's weights, the file's
capacity dropping no choice, the configuration checked key by key (and
the port's gates, which part from the published model's), the weight law,
and the decode work."""
import dataclasses
import json

import pytest
import torch

from repro_torch.models import transformer
from repro_torch.models.layers import moe

from skybench import harness, work
from skybench.data.lm_weights import block_weights, blocks, layer_kinds
from skybench.reference import lm as ref
from skybench.tests._tiny import with_kept
from skybench.work_lm import decode_work, occupied_experts

CPU = torch.device("cpu")
LM_CELLS = [w for w in with_kept(harness.load_bench())["workloads"]
            if harness.load_config(w["config"]).get("family") == "lm"]
CONF = harness.load_config(LM_CELLS[0]["config"])
FAMILY = harness.load_family(CONF)
tiny_lm = FAMILY.tiny_lm


def _weights(model, seed, dtype=torch.bfloat16):
    return lambda block: block_weights(model, block, seed, dtype, CPU)


def _kinds(model):
    return [tuple(harness.load_kind(k) for k in layer)
            for layer in layer_kinds(model)]


def _ports_forward(cfg, model, seed, toks):
    params = transformer.Transformer(cfg, dtype=torch.float32, device=CPU)
    FAMILY.fill(params, model, seed, torch.bfloat16)
    with torch.no_grad():
        return transformer.forward(params, cfg, tokens=toks, remat=False)[0]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_the_reference_is_the_ports_forward(seed):
    """On the law's weights in a float32 tree, the port's forward and the
    plain reference give the same logits to float32 rounding."""
    cfg, model = tiny_lm(CONF)
    toks = torch.randint(0, model["vocab_size"], (3, 12), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))
    want = _ports_forward(cfg, model, seed, toks)
    got = ref.forward(model, _weights(model, seed), toks, 0,
                      kinds=_kinds(model))
    assert (got.logits - want).abs().max() <= 1e-5 * want.abs().max()
    assert len(got.routes) == sum(f == "ffn_moe"
                                  for _, f in layer_kinds(model))


def test_the_files_capacity_keeps_every_choice():
    """At the cell's sizes (decode: the batch; prefill: every prompt
    token) ``capacity_for`` gives a slot for every token, and a tiny
    prefill and decode at factor E / k drop nothing."""
    for cell in LM_CELLS:
        conf = harness.load_config(cell["config"])
        mix = harness.load_traffic(cell["traffic"])
        m = harness.load_family(conf).arch_config(conf).moe
        for tokens in (mix["batch"], mix["batch"] * mix["prompt_len"]):
            assert moe.capacity_for(m, tokens) >= tokens
    cfg, model = tiny_lm(CONF)
    params = transformer.Transformer(cfg, dtype=torch.float32, device=CPU)
    FAMILY.fill(params, model, 5, torch.bfloat16)
    toks = torch.randint(0, model["vocab_size"], (4, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    with torch.inference_mode(), moe.recorded_routes(params) as routes:
        logits, caches = transformer.prefill(params, cfg, tokens=toks,
                                             max_len=20)
        token = logits.argmax(-1).to(torch.int32)
        for pos in range(16, 20):
            logits, caches = transformer.decode_step(
                params, caches, cfg, token=token, pos=pos)
            token = logits.argmax(-1).to(torch.int32)
    assert routes and all(bool(r["keep"].all()) for r in routes)


def test_the_config_is_checked_key_by_key():
    """The file states the published model; the port's check refuses it
    on the one key the port has no setting for (its MoE renormalises the
    top-k gates), passes it with the port's value there, and refuses any
    other departure."""
    with pytest.raises(ValueError, match="norm_topk_prob"):
        harness.port_config(CONF)
    assert CONF["model"]["norm_topk_prob"] is False
    ports = json.loads(json.dumps(CONF))
    ports["model"]["norm_topk_prob"] = True
    cfg = FAMILY.port_config(ports)
    assert cfg.moe.capacity_factor == \
        CONF["changed"]["moe.capacity_factor"]["value"]
    assert FAMILY.model_of(cfg) == {**FAMILY.model_of(cfg), **ports["model"]}
    for key, value in (("hidden_size", 2304), ("num_experts_per_tok", 8),
                       ("no_such_key", 1)):
        bad = json.loads(json.dumps(ports))
        bad["model"][key] = value
        with pytest.raises(ValueError, match=key):
            FAMILY.port_config(bad)


@pytest.mark.parametrize("seed", [2, 2**31 + 5])
def test_the_ports_gates_are_not_the_published_models(seed):
    """Why the decode cell is out: the reference on the published gates
    (not renormalised) parts from the port's forward by far more than
    rounding, where on the port's renormalised gates it agrees."""
    cfg, model = tiny_lm(CONF)
    toks = torch.randint(0, model["vocab_size"], (3, 12), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))
    want = _ports_forward(cfg, model, seed, toks)
    scale = want.abs().max()
    ports = ref.forward(model, _weights(model, seed), toks, 0,
                        kinds=_kinds(model)).logits
    published = ref.forward({**model, "norm_topk_prob": False},
                            _weights(model, seed), toks, 0,
                            kinds=_kinds(model)).logits
    assert (ports - want).abs().max() <= 1e-5 * scale
    assert (published - want).abs().max() >= 1e-2 * scale


def test_the_weight_law_draws_each_block_alone_alike():
    _, model = tiny_lm(CONF)
    for block in blocks(model):
        a = block_weights(model, block, 9, torch.bfloat16, CPU)
        b = block_weights(model, block, 9, torch.bfloat16, CPU)
        c = block_weights(model, block, 10, torch.bfloat16, CPU)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
        drawn = [k for k in a if not k.startswith(("norm", "final"))]
        assert drawn and all(not torch.equal(a[k], c[k]) for k in drawn)
    w = block_weights(model, layer_kinds(model).index(
        ("attn_full", "ffn_moe")), 9, torch.bfloat16, CPU)
    assert w["ffn.router"].dtype == torch.float32
    assert w["ffn.w_gate"].dtype == torch.bfloat16
    d = model["hidden_size"]
    assert float(w["mixer.wq"].float().std()) == pytest.approx(d ** -0.5,
                                                               rel=0.1)


def test_fill_writes_every_parameter():
    cfg, model = tiny_lm(CONF)
    params = transformer.Transformer(cfg, dtype=torch.bfloat16, device=CPU)
    FAMILY.fill(params, model, 3, torch.bfloat16)
    head = block_weights(model, "head", 3, torch.bfloat16, CPU)["embed.head"]
    assert torch.equal(params.embed.head, head)
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="w_gate"):
        FAMILY.fill(transformer.Transformer(wider, device=CPU), model, 3,
                    torch.bfloat16)


def test_occupied_experts_counts_distinct_choices():
    routes = [torch.tensor([[[0, 1], [2, 3]], [[1, 0], [2, 2]]])]  # (B, S, k)
    assert occupied_experts(routes, 0, 1) == 2.0
    assert occupied_experts(routes, 0, 2) == 2.0
    assert occupied_experts(routes, 1, 1) == 2.0


def test_decode_work_of_one_step():
    model = dict(CONF["model"], num_hidden_layers=2, hidden_size=4,
                 intermediate_size=6, vocab_size=10, num_attention_heads=2,
                 num_key_value_heads=1, head_dim=2, n_routed_experts=4,
                 num_experts_per_tok=2, moe_intermediate_size=3,
                 n_shared_experts=1,
                 layers=[[1, [["attn_full", "ffn_dense"]]],
                         [1, [["attn_full", "ffn_moe"]]]])
    parts = {lw.name: lw for lw in decode_work(model, [5], batch=3,
                                               occupied=2.5)}
    proj = 4 * 2 * (2 * 2 + 2 * 1)
    assert parts["attn.proj"] == (
        "attn.proj", 2 * proj * 3 * 2, 2 * proj * 2)
    # 6 cached positions: scores and weighted values, 2 heads of 2
    assert parts["attn.cache"].flops == 4 * 2 * 2 * 6 * 3 * 2
    assert parts["attn.cache"].bytes == 2 * 2 * 1 * 2 * 3 * (6 + 1) * 2
    assert parts["ffn.dense"] == ("ffn.dense", 2 * 72 * 3, 2 * 72)
    assert parts["moe.experts"] == ("moe.experts", 2 * 36 * 2 * 3,
                                    2 * 36 * 2.5)
    assert parts["moe.router"].bytes == 4 * 4 * 4
    assert parts["head"] == ("head", 2 * 40 * 3,
                             2 * (40 + 4 * 3 + 10 * 3))
    two = work.total(decode_work(model, [5, 6], 3, 2.5))
    one = work.total(decode_work(model, [5], 3, 2.5))
    assert two.flops > 2 * one.flops - 1e-9       # a longer cache
