"""Fault runtime of the serving engine: bounded retry
(``fault_tolerance``), seeded fault injection (``faults``) and straggler
detection (``straggler``)."""
