"""``ffn_moe``: routed experts with shared ones, with no capacity.

Leaves (under a layer's ``ffn``): ``router`` (d, E) in float32, scale
d^-1/2 (router logits of unit variance on a unit-rms input); ``w_gate``,
``w_up`` (E, d, de), scale d^-1/2; ``w_down`` (E, de, d), scale de^-1/2;
with ``n_shared_experts`` ns, ``shared.w_gate``, ``shared.w_up`` (d, ns
de) and ``shared.w_down`` (ns de, d).

The reference: the softmax of the float32 router's logits, the top
``num_experts_per_tok`` gates (renormalised to sum 1 where
``norm_topk_prob`` says so), each expert's SwiGLU over the tokens that
chose it, weighted by their gates, plus the shared experts' SwiGLU over
every token.  It returns the choices (B, S, k) beside the output.

A decode step's work: 2 per router weight and per weight of the k chosen
and the shared experts, per token; bytes: the router (float32) and the
shared experts once a step, and of the routed experts only those that
some token of the step chose (``occupied``).
"""
import torch

from skybench.reference.lm import mm, swiglu
from skybench.work import LayerWork

def leaves(model):
    d = model["hidden_size"]
    E, de = model["n_routed_experts"], model["moe_intermediate_size"]
    out = {"router": ((d, E), d ** -0.5, torch.float32),
           "w_gate": ((E, d, de), d ** -0.5, None),
           "w_up": ((E, d, de), d ** -0.5, None),
           "w_down": ((E, de, d), de ** -0.5, None)}
    ns = model["n_shared_experts"]
    if ns:
        out.update({"shared.w_gate": ((d, ns * de), d ** -0.5, None),
                    "shared.w_up": ((d, ns * de), d ** -0.5, None),
                    "shared.w_down": ((ns * de, d), (ns * de) ** -0.5,
                                      None)})
    return out


def reference(model, w, h, control):
    B, S, d = h.shape
    E, k = model["n_routed_experts"], model["num_experts_per_tok"]
    x = h.reshape(-1, d)
    gates = torch.softmax(mm(x, w["router"], control), dim=-1)
    top_v, top_i = torch.topk(gates, k, dim=-1)
    if model["norm_topk_prob"]:
        top_v = top_v / top_v.sum(-1, keepdim=True)
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok, wts = order // k, top_v.reshape(-1)[order]
    out = torch.zeros_like(x)
    start = 0
    for e, n in enumerate(torch.bincount(flat, minlength=E).tolist()):
        if n:
            idx = tok[start:start + n]
            y = swiglu(x[idx], w["w_gate"][e], w["w_up"][e], w["w_down"][e],
                       control)
            out.index_add_(0, idx, y * wts[start:start + n, None])
        start += n
    if model["n_shared_experts"]:
        out += swiglu(x, w["shared.w_gate"], w["shared.w_up"],
                      w["shared.w_down"], control)
    return out.view(B, S, d), top_i.view(B, S, k)


def decode_work(model, cached, steps, batch, occupied, wbytes):
    d, E = model["hidden_size"], model["n_routed_experts"]
    k, ns = model["num_experts_per_tok"], model["n_shared_experts"]
    n = 3 * d * model["moe_intermediate_size"]
    tokens = batch * steps
    out = [LayerWork("moe.router", 2.0 * d * E * tokens, 4.0 * d * E * steps),
           LayerWork("moe.experts", 2.0 * n * k * tokens,
                     wbytes * n * occupied * steps)]
    if ns:
        out.append(LayerWork("moe.shared", 2.0 * n * ns * tokens,
                             wbytes * n * ns * steps))
    return out
