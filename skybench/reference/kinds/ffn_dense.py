"""``ffn_dense``: SwiGLU, ``w_down(silu(x w_gate) * (x w_up))``.

Leaves (under a layer's ``ffn``): ``w_gate``, ``w_up`` (d, d_ff), scale
d^-1/2; ``w_down`` (d_ff, d), scale d_ff^-1/2.  A decode step's work: 2
per weight per token, every weight read once a step.
"""
from skybench.reference.lm import swiglu
from skybench.work import LayerWork

def leaves(model):
    d, f = model["hidden_size"], model["intermediate_size"]
    return {"w_gate": ((d, f), d ** -0.5, None),
            "w_up": ((d, f), d ** -0.5, None),
            "w_down": ((f, d), f ** -0.5, None)}


def reference(model, w, h, control):
    return swiglu(h, w["w_gate"], w["w_up"], w["w_down"], control), None


def decode_work(model, cached, steps, batch, occupied, wbytes):
    n = 3 * model["hidden_size"] * model["intermediate_size"]
    return [LayerWork("ffn.dense", 2.0 * n * batch * steps,
                      wbytes * n * steps)]
