"""Online upgrade (paper §4.8) — the high-velocity feature.

Protocol:
  1. ``freeze`` the mount's op gate and drain in-flight operations
     (no ownership can be stranded: the boundary never transferred it),
  2. ``extract_state()`` from the old module (schema-checked),
  3. optional ``migrate`` hook maps old-version state to the new version,
  4. instantiate + ``init`` the new module, ``restore_state``,
  5. atomically swap the function table, ``thaw``.

Applications see only a pause (measured in benchmarks/fs_upgrade.py).
The same quiesce→extract→restore protocol implements checkpoint/restart and
elastic rescale for trainer modules (repro_torch.train.trainer).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from repro_torch.core.interface import BentoFilesystem, BentoModule
from repro_torch.core.registry import Mount, _FS_OPS


class UpgradeError(Exception):
    pass


def _extracted_state(old: BentoModule, new: BentoModule,
                     migrate: Optional[Callable],
                     strict_schema: bool) -> Dict[str, Any]:
    """Extract + migrate + schema-check: the ONE state-transfer front door.

    Both the mount upgrade path and generic module transfer (trainer
    substrates) go through here, so a new version whose schema expects keys
    the old version never emitted fails loudly in either path instead of
    silently restoring partial state."""
    state = old.extract_state()
    if migrate is not None:
        state = migrate(state, old.VERSION, new.VERSION)
    if strict_schema:
        # layer-aware: keys the new module can synthesize itself (a
        # stackable layer's private state, bootstrapped on a plain->layered
        # upgrade) are not required of the OLD module's extract
        optional = set(getattr(new, "optional_state_keys", lambda: ())())
        missing = set(new.state_schema()) - set(state) - optional
        if missing:
            raise UpgradeError(
                f"state transfer incomplete: {sorted(missing)} missing "
                f"(old v{old.VERSION} -> new v{new.VERSION})")
    return state


def upgrade(mount: Mount, new_module: BentoFilesystem,
            migrate: Optional[Callable[[Dict, int, int], Dict]] = None,
            strict_schema: bool = True) -> Dict[str, float]:
    """Swap the mounted module for ``new_module`` without unmounting.

    Returns timing stats {quiesce_s, transfer_s, total_s}.
    """
    old = mount.module
    t0 = time.perf_counter()
    mount.gate.freeze()
    t_quiesce = time.perf_counter() - t0
    try:
        state = _extracted_state(old, new_module, migrate, strict_schema)
        t1 = time.perf_counter()
        sb = mount.services.superblock()
        new_module.init(sb, mount.services)
        new_module.restore_state(state, old.VERSION)
        # Atomic table swap: dispatch uses the table, never the module object.
        mount.module = new_module
        mount.table = {op: getattr(new_module, op) for op in _FS_OPS}
        mount.generation += 1
        old.destroy()
        t_transfer = time.perf_counter() - t1
    finally:
        mount.gate.thaw()
    return {"quiesce_s": t_quiesce, "transfer_s": t_transfer,
            "total_s": time.perf_counter() - t0}


# --- stackable layers: wrap/unwrap a live mount (the paper's §6 demo) -----------------
#
# The provenance demo is "add a feature to a RUNNING file system": wrap the
# mounted module in a stackable layer (repro_torch.fs.prov) with no remount, then
# strip it again. Both directions are ordinary upgrades — the layer's
# restore_state forwards the inner module's keys to a fresh inner instance
# (open handles stay valid: inos are device state; the dentry cache lives in
# PosixView above the swap; the journal position rides the "journal" state
# key) and bootstraps its own private state, declared optional via
# ``optional_state_keys`` so the plain module's extract passes the schema
# check.


def _fresh_like(module: BentoModule) -> BentoModule:
    """A fresh instance of ``module``'s class, preserving its policy options
    (the fs classes take them as the sole constructor arg)."""
    cls = type(module)
    opts = getattr(module, "opts", None)
    if opts is not None:
        try:
            return cls(opts)
        except TypeError:
            pass
    return cls()


def wrap_layer(mount: Mount, make_layer: Callable[[BentoFilesystem],
                                                  BentoFilesystem],
               migrate: Optional[Callable] = None) -> Dict[str, float]:
    """Hot-swap the mounted module for ``make_layer(fresh_inner)`` — e.g.
    ``wrap_layer(mount, ProvFilesystem)`` adds provenance tracking to a
    live mount. Returns the upgrade timing stats (the measured pause).
    One layer deep only: wrapping an already-layered mount is refused
    (``_fresh_like`` would rebuild the layer around its options object,
    not its module — unwrap first)."""
    if getattr(mount.module, "inner", None) is not None:
        raise UpgradeError(
            f"mount already carries a stackable layer "
            f"({type(mount.module).__name__}) — unwrap it first")
    return upgrade(mount, make_layer(_fresh_like(mount.module)),
                   migrate=migrate)


def unwrap_layer(mount: Mount,
                 migrate: Optional[Callable] = None) -> Dict[str, float]:
    """The reverse demo: strip the mounted stackable layer, downgrading to
    a fresh instance of its inner module's class. The layer's private state
    keys ride along in the extracted dict and are simply ignored by the
    plain module's restore; its on-device artifacts (the provenance log)
    stay durable for the next wrap."""
    layer = mount.module
    if getattr(layer, "inner", None) is None:
        raise UpgradeError(
            f"mounted module {type(layer).__name__} is not a stackable "
            "layer — nothing to unwrap")
    return upgrade(mount, _fresh_like(layer.inner), migrate=migrate)


# --- generic module upgrade (trainer substrates) --------------------------------------


def transfer_state(old: BentoModule, new: BentoModule,
                   migrate: Optional[Callable] = None,
                   strict_schema: bool = True) -> None:
    """Quiesce-free state transfer between module instances (trainer
    substrates, checkpoint/restart). Applies the same strict_schema check
    as the mount upgrade path: a trainer upgrade can no more silently drop
    state keys than a file-system upgrade can."""
    state = _extracted_state(old, new, migrate, strict_schema)
    new.restore_state(state, old.VERSION)
