"""Scope: hierarchical name -> tensor store.

Counterpart of paddle_tpu/core/scope.py (parity: framework/scope.h:46,
Scope::Var/FindVar/NewScope with parent-chain lookup).  Values are torch
tensors on the Executor's device (or numpy arrays not yet placed there);
the Executor reads persistables from here, runs the step, and writes the
updated persistables back as new, detached tensors — it never writes a
scope tensor in place, so a reference to a value stays that value.
"""
from __future__ import annotations


class Scope:
    def __init__(self, parent: "Scope" = None):
        self._vars: dict[str, object] = {}
        self._parent = parent
        self._kids: list[Scope] = []

    def var(self, name: str):
        """Get-or-create semantics like Scope::Var (scope.h:52)."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars[name]

    def set_var(self, name: str, value):
        self._vars[name] = value

    def find_var(self, name: str):
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope._vars[name]
            scope = scope._parent
        return None

    def has_var(self, name: str) -> bool:
        scope = self
        while scope is not None:
            if name in scope._vars:
                return True
            scope = scope._parent
        return False

    def erase(self, name: str):
        self._vars.pop(name, None)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def local_var_names(self):
        return list(self._vars)

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
