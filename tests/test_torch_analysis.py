"""The reference's static checker (``repro.analysis``) over the port.

Its rules apply to ``src/repro_torch`` as they stand (clock discipline,
the ``_GUARDED_BY`` lock registries of the engine, batcher, dispatcher,
supervisor, metrics, futures, trace and fault modules, frozen specs,
``__all__`` exports): the port must give no finding, the mesh runtime's
shared state included.  No rule is edited for the port.
"""
from pathlib import Path

import pytest

from repro.analysis import rule_registry, run_analysis

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("rule", sorted(rule_registry()))
def test_port_has_no_finding(rule):
    findings = run_analysis([PORT], rules=[rule])
    assert not findings, "\n".join(str(f) for f in findings)
