"""The LM substrate (the reference's ``repro.models``): the layer modules,
the stacked model ``transformer`` and the step functions of ``lm``, for
the dense family's serving path (``ATTN_FULL``, ``ATTN_SLIDING`` and
``FFN_DENSE``; prefill and decode), and the closed-form ``counting``.
The other mixer and FFN kinds raise ``NotImplementedError`` when a model
is built (ROADMAP queue 1, item 14)."""
