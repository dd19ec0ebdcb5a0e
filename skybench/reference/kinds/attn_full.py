"""``attn_full``: multi-head attention with grouped KV heads over the
whole causal prefix.

Leaves (the port's names under a layer's ``mixer``): ``wq`` (d, nq, hd),
``wk``, ``wv`` (d, nkv, hd), scale d^-1/2; ``wo`` (nq, hd, d), scale
(nq hd)^-1/2.  The reference: q head h reads KV head h // (nq / nkv), RoPE
by half rotation at ``rope_theta``, a causal softmax in float32 scaled by
hd^-1/2, over the whole batch at once.  A decode step's work: 2 per
projection weight per token, 4 per (query head, head dim, cached
position), the projections read once a step, the cache read up to the
position and the step's K and V written.
"""
import torch

from skybench.reference.lm import mm, rope
from skybench.work import LayerWork

def _heads(model):
    return (model["num_attention_heads"], model["num_key_value_heads"],
            model["head_dim"])


def leaves(model):
    d = model["hidden_size"]
    nq, nkv, hd = _heads(model)
    return {"wq": ((d, nq, hd), d ** -0.5, None),
            "wk": ((d, nkv, hd), d ** -0.5, None),
            "wv": ((d, nkv, hd), d ** -0.5, None),
            "wo": ((nq, hd, d), (nq * hd) ** -0.5, None)}


def reference(model, w, h, control):
    B, S, d = h.shape
    nq, nkv, hd = _heads(model)
    q = mm(h, w["wq"].reshape(d, -1), control).view(B, S, nq, hd)
    k = mm(h, w["wk"].reshape(d, -1), control).view(B, S, nkv, hd)
    v = mm(h, w["wv"].reshape(d, -1), control).view(B, S, nkv, hd)
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    g = nq // nkv
    q = q.transpose(1, 2)                                     # (B, nq, S, hd)
    k = k.repeat_interleave(g, 2).transpose(1, 2)
    v = v.repeat_interleave(g, 2).transpose(1, 2)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = mm(q, k.transpose(-1, -2), control) * hd ** -0.5
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = mm(probs, v, control).transpose(1, 2)
    return mm(out.reshape(B, S, nq * hd), w["wo"].reshape(nq * hd, d),
              control), None


def decode_work(model, cached, steps, batch, occupied, wbytes):
    d = model["hidden_size"]
    nq, nkv, hd = _heads(model)
    proj = d * hd * (2 * nq + 2 * nkv)
    return [LayerWork("attn.proj", 2.0 * proj * batch * steps,
                      wbytes * proj * steps),
            LayerWork("attn.cache", 4.0 * nq * hd * cached * batch,
                      wbytes * 2 * nkv * hd * batch * (cached + steps))]
