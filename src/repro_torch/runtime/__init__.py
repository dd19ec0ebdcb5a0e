"""Fault runtime: bounded retry for the serving engine's lanes and the
training loop's ``ResilientLoop`` (``fault_tolerance``), seeded fault
injection (``faults``) and straggler detection (``straggler``)."""
