"""Unique name generator: a copy of paddle_tpu/core/unique_name.py (parity:
python/paddle/fluid/unique_name.py), so programs built by either package
carry the same variable names.

Thread-unsafe by design, matching the reference: program construction is a
single-threaded activity.
"""
from __future__ import annotations

import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: dict[str, int] = {}

    def __call__(self, key: str) -> str:
        tmp = self.ids.setdefault(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return _generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    """Scope a fresh name generator, so that two builds of one model
    carry the same names."""
    global _generator
    if new_generator is None:
        new_generator = UniqueNameGenerator()
    elif isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = _generator
    _generator = new_generator
    try:
        yield
    finally:
        _generator = old
