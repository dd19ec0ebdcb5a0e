"""The LM substrate (the reference's ``repro.models``): the layer modules,
the stacked model ``transformer`` and the step functions of ``lm``, for
the serving path (prefill and decode) of every layer kind of the
reference (``ATTN_FULL``, ``ATTN_SLIDING``, ``ATTN_MLA``, ``MAMBA``,
``RWKV6``, ``FFN_DENSE``, ``FFN_MOE``), and the closed-form
``counting``."""
