"""The LM substrate (the reference's ``repro.models``): the layer modules,
the stacked model ``transformer`` and the step functions of ``lm``, for
the serving path (prefill and decode) of ``ATTN_FULL``, ``ATTN_SLIDING``,
``ATTN_MLA``, ``FFN_DENSE`` and ``FFN_MOE``, and the closed-form
``counting``.  ``MAMBA`` and ``RWKV6`` raise ``NotImplementedError`` when a
model is built (ROADMAP queue 1, items 14c and 14d)."""
