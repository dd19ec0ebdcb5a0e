"""The LM layers: ``norms``, ``rope``, ``embedding``, ``ffn`` and
``attention``, each an ``nn.Module`` whose parameters keep the reference's
leaf names, plus module-level functions with the reference's names."""
