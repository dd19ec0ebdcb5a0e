"""A barrier across processes for the mesh tests: ``AtOnce`` wraps a shard
call (a module-level function, named so that it pickles by reference to
the unpatched module) and makes each call wait until ``parties`` calls
have arrived, each leaving a file named by its process id in
``directory``.  Calls that run one after another time out at the first.
"""
import importlib
import os
import time
import uuid
from pathlib import Path


class AtOnce:
    def __init__(self, directory, parties: int, module: str, name: str,
                 timeout: float = 20.0):
        self.directory, self.parties = str(directory), parties
        self.module, self.name, self.timeout = module, name, timeout

    def __call__(self, *args):
        Path(self.directory, f"{os.getpid()}-{uuid.uuid4().hex}").touch()
        deadline = time.monotonic() + self.timeout
        while len(os.listdir(self.directory)) < self.parties:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{self.name}: {len(os.listdir(
                    self.directory))} of {self.parties} calls arrived")
            time.sleep(0.01)
        return getattr(importlib.import_module(self.module), self.name)(*args)

    def pids(self):
        return {int(f.split("-")[0]) for f in os.listdir(self.directory)}
