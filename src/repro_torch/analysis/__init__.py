"""Static checks of the port's own invariants.

- ``cuda_abi``: every kernel's ``extern "C"`` launch signature in
  ``kernels/csrc`` has a ctypes type for each parameter (``kernels._build``
  reads the argument types from it), and every ``_build.entry`` call names
  one of them (the port's counterpart of the reference's
  ``pallas-consistency`` rule).
"""
from repro_torch.analysis.cuda_abi import AbiFinding, check_cuda_abi

__all__ = ["AbiFinding", "check_cuda_abi"]
