"""The LM layers: ``norms``, ``rope``, ``embedding``, ``ffn``,
``attention``, ``mla`` (DeepSeek's latent attention), ``moe`` (routed
experts with shared ones), ``mamba`` (Jamba's selective SSM) and ``rwkv``
(the RWKV-6 time-mix), each an ``nn.Module`` whose parameters keep the
reference's leaf names, plus module-level functions with the reference's
names."""
