"""cuda-abi: the kernels' C entry points against the wrappers that bind them.

``kernels._build`` gives each launch function the ctypes argument types of
its own ``extern "C"`` signature in ``kernels/csrc`` (``_build.argtypes``),
and ``_build.launch`` refuses a call that passes another number of
arguments, so no hand-written declaration can drift from the C function.
Both happen only on the card, where a library loads; this rule checks on
any machine what they rely on:

1. every parameter of every ``extern "C" int`` function in
   ``kernels/csrc/*.cu`` is of a kind with a ctypes type (pointer, int,
   long long, float), and the last is ``void* stream``;
2. every ``_build.entry`` call in ``kernels/*.py`` names its source and
   entry point with string literals (or a conditional between literals),
   and each names an ``extern "C"`` function of that source.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.kernels._build import CTYPES, c_signatures, extern_functions

__all__ = ["AbiFinding", "c_signatures", "check_cuda_abi"]

KERNELS = Path(__file__).resolve().parents[1] / "kernels"


@dataclass(frozen=True)
class AbiFinding:
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: cuda-abi: {self.message}"


def _literals(node: ast.expr) -> Optional[List[str]]:
    """The strings ``node`` may be: a literal, or a conditional between
    literals; None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        body, orelse = _literals(node.body), _literals(node.orelse)
        return None if body is None or orelse is None else body + orelse
    return None


def _is_entry_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "entry"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "_build")


def check_cuda_abi(kernels: Path = KERNELS,
                   checked: Optional[List[Tuple[str, int, str]]] = None
                   ) -> List[AbiFinding]:
    """Findings of the rule over the sources in ``kernels/csrc`` and the
    wrappers in ``kernels`` (empty when all is well); ``checked``, if
    given, receives (file name, line, entry) of every entry point a
    wrapper names."""
    findings: List[AbiFinding] = []
    for path in sorted((kernels / "csrc").glob("*.cu")):
        for name, kinds, line in extern_functions(path):
            bad = [k for k in kinds if k not in CTYPES]
            if bad:
                findings.append(AbiFinding(str(path), line, (
                    f"{name} takes parameters of no ctypes kind: {bad}")))
            if not kinds or kinds[-1] != "stream":
                findings.append(AbiFinding(str(path), line, (
                    f"{name}'s last parameter is not void* stream")))
    sigs = c_signatures(kernels / "csrc")
    for path in sorted(kernels.glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for call in filter(_is_entry_call, ast.walk(tree)):
            args = [_literals(a) for a in call.args]
            if not 1 <= len(args) <= 2 or call.keywords or None in args:
                findings.append(AbiFinding(str(path), call.lineno, (
                    f"{ast.unparse(call)} does not name its source and "
                    f"entry point with string literals")))
                continue
            for name in args[0]:
                for entry in (args[1] if len(args) > 1
                              else [f"{name}_launch"]):
                    if checked is not None:
                        checked.append((path.name, call.lineno, entry))
                    if entry not in sigs.get(name, {}):
                        findings.append(AbiFinding(str(path), call.lineno, (
                            f"{entry} is not an extern \"C\" function of "
                            f"csrc/{name}.cu")))
    return findings
