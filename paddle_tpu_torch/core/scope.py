"""Scope: name -> tensor store.

Counterpart of paddle_tpu/core/scope.py (parity: framework/scope.h:46),
without child scopes: no ported path makes one.  Values are torch
tensors on the Executor's device (or numpy arrays not yet placed there);
the Executor reads persistables from here, runs the step, and writes the
updated persistables back as detached tensors.
"""
from __future__ import annotations


class Scope:
    def __init__(self):
        self._vars: dict[str, object] = {}

    def set_var(self, name: str, value):
        self._vars[name] = value

    def find_var(self, name: str):
        return self._vars.get(name)

    def __repr__(self):
        return f"Scope({len(self._vars)} vars)"


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class scope_guard:
    """``with scope_guard(scope):`` — swap the global scope (parity:
    fluid.executor.scope_guard)."""

    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        global _global_scope
        self.old = _global_scope
        _global_scope = self.scope
        return self.scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self.old
        return False
