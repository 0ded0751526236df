"""Ownership / borrow model across the extension boundary (paper §4.4).

Contract: ownership of an object never crosses the interface; callers lend
(mutably XOR shared) and the callee may only touch the object inside the
borrow window. Rust proves this at compile time; here the runtime tracks
borrows and raises on violations, and hypothesis property tests fuzz the
contract (tests/test_core_contracts.py, which the reference package runs).

The guards below exist for *host-side* mutable objects: buffer-cache
blocks, journal state, caches.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class BorrowError(Exception):
    pass


class Owned:
    """An object owned by one side of the boundary; lendable, never given."""

    __slots__ = ("_value", "_shared", "_mut", "_lock", "name")

    def __init__(self, value: Any, name: str = "object"):
        self._value = value
        self._shared = 0
        self._mut = False
        self._lock = threading.Lock()
        self.name = name

    # --- lending --------------------------------------------------------------
    def borrow(self) -> "Borrow":
        with self._lock:
            if self._mut:
                raise BorrowError(f"{self.name}: shared borrow while mutably lent")
            self._shared += 1
        return Borrow(self, mutable=False)

    def borrow_mut(self) -> "Borrow":
        with self._lock:
            if self._mut or self._shared:
                raise BorrowError(
                    f"{self.name}: mutable borrow requires exclusivity "
                    f"(shared={self._shared}, mut={self._mut})")
            self._mut = True
        return Borrow(self, mutable=True)

    def _release(self, mutable: bool) -> None:
        with self._lock:
            if mutable:
                self._mut = False
            else:
                self._shared -= 1

    @property
    def is_lent(self) -> bool:
        with self._lock:
            return self._mut or self._shared > 0

    def take(self) -> Any:
        """Owner-side: reclaim the value; fails while lent (paper §3.2.1 —
        the upgrade path must wait for all borrows to return)."""
        with self._lock:
            if self._mut or self._shared:
                raise BorrowError(f"{self.name}: cannot take while lent")
            return self._value


class Borrow:
    """A borrow window; use as a context manager. Access outside the window
    (use-after-return — the C analogue of a dangling pointer) raises."""

    __slots__ = ("_owner", "_mutable", "_open")

    def __init__(self, owner: Owned, mutable: bool):
        self._owner = owner
        self._mutable = mutable
        self._open = True

    @property
    def mutable(self) -> bool:
        return self._mutable

    def get(self) -> Any:
        if not self._open:
            raise BorrowError(f"{self._owner.name}: access after borrow ended")
        return self._owner._value

    def set(self, value: Any) -> None:
        if not self._open:
            raise BorrowError(f"{self._owner.name}: access after borrow ended")
        if not self._mutable:
            raise BorrowError(f"{self._owner.name}: write through shared borrow")
        self._owner._value = value

    def end(self) -> None:
        if self._open:
            self._open = False
            self._owner._release(self._mutable)

    def __enter__(self) -> "Borrow":
        return self

    def __exit__(self, *exc) -> None:
        self.end()

    def __del__(self):  # leak detector: a GC'd open borrow is a missing brelse
        if getattr(self, "_open", False):
            self.end()
