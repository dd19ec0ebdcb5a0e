"""The LM layers: ``norms``, ``rope``, ``embedding``, ``ffn``,
``attention``, ``mla`` (DeepSeek's latent attention) and ``moe`` (routed
experts with shared ones), each an ``nn.Module`` whose parameters keep the
reference's leaf names, plus module-level functions with the reference's
names."""
