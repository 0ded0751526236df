"""Capability types (paper §4.6).

The kernel operates on raw handles; exposing them directly to extensions
would void every safety property. Instead the runtime ("kernel") mints
*capability types* — unforgeable wrappers whose possession is proof of
access. Extensions cannot construct them (private mint token), cannot cast
them, and can only reach the underlying resource through the methods the
capability exposes.

In Rust this is a compile-time guarantee; in Python we enforce it at
runtime (mint-token check in ``__init__``) and under test (the capability
contract suite in tests/test_core_contracts.py). The *architecture* — what
may cross the boundary — matches the paper exactly.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    import torch

_MINT = object()  # private mint token — only this module can create capabilities


class CapabilityError(Exception):
    """An extension tried to forge, copy or misuse a capability."""


class Capability:
    """Base: unforgeable handle around a kernel object."""

    __slots__ = ("_obj", "_revoked")

    def __init__(self, obj: Any, _token: Any = None):
        if _token is not _MINT:
            raise CapabilityError(
                f"{type(self).__name__} cannot be constructed by extensions; "
                "it is minted by the runtime only")
        self._obj = obj
        self._revoked = False

    # -- runtime-side API ------------------------------------------------------
    @classmethod
    def _mint(cls, obj: Any, *args, **kw) -> "Capability":
        return cls(obj, *args, _token=_MINT, **kw)

    def _revoke(self) -> None:
        """Kernel-side: invalidate (used during online upgrade quiesce)."""
        self._revoked = True

    def _raw(self) -> Any:
        """Kernel-side only: unwrap. Named with underscore; extensions using
        it are violating the contract (checked in review/tests, as unsafe
        blocks are in Rust)."""
        self._check()
        return self._obj

    def _check(self) -> None:
        if self._revoked:
            raise CapabilityError(
                f"{type(self).__name__} used after revocation (stale handle "
                "across an upgrade or unmount)")

    def __reduce__(self):  # capabilities must not be serialized/smuggled
        raise CapabilityError("capabilities cannot be pickled")

    def __deepcopy__(self, memo):
        raise CapabilityError("capabilities cannot be copied")


class SuperBlockCap(Capability):
    """Proof of access to a mounted file system's superblock (§4.6).

    Exposes exactly what a file system needs: geometry reads and block I/O
    through the buffer cache (``sb_bread`` analogue lives on the kernel
    services API, which requires this capability as proof).
    """

    @property
    def block_size(self) -> int:
        self._check()
        return self._obj.block_size

    @property
    def n_blocks(self) -> int:
        self._check()
        return self._obj.n_blocks

    @property
    def device_id(self) -> str:
        self._check()
        return self._obj.device_id


class BlockDeviceCap(Capability):
    """Raw device grant (mkfs and the journal need it)."""

    @property
    def n_blocks(self) -> int:
        self._check()
        return self._obj.n_blocks

    @property
    def block_size(self) -> int:
        self._check()
        return self._obj.block_size


class MeshCap(Capability):
    """Grant of the device mesh to distributed extensions (trainer modules).

    Extensions may *read* topology and build shardings; they may not
    re-initialize the runtime or grab raw devices.
    """

    @property
    def axis_names(self):
        self._check()
        return tuple(self._obj.axis_names)

    @property
    def shape(self):
        self._check()
        return tuple(self._obj.devices.shape)

    def sharding_ctx(self, ruleset: str = "baseline"):
        self._check()
        from repro_torch.distributed.sharding import ShardingCtx
        return ShardingCtx.for_mesh(self._obj, ruleset)


class RngCap(Capability):
    """Deterministic RNG stream grant (extensions cannot reseed globally).

    Holds a ``torch.Generator``; each ``next_key`` splits a child
    generator off the stream, seeded from the stream's next draw."""

    def next_key(self) -> "torch.Generator":
        import torch

        self._check()
        seed = int(torch.randint(0, 2**62, (), generator=self._obj["gen"]))
        return torch.Generator().manual_seed(seed)


class MetricsCap(Capability):
    """Append-only metrics channel (extensions cannot read others' metrics)."""

    def emit(self, name: str, value: float, step: Optional[int] = None) -> None:
        self._check()
        self._obj.append((name, float(value), step))


def mint_superblock(state) -> SuperBlockCap:
    return SuperBlockCap._mint(state)


def mint_blockdev(dev) -> BlockDeviceCap:
    return BlockDeviceCap._mint(dev)


def mint_mesh(mesh) -> MeshCap:
    return MeshCap._mint(mesh)


def mint_rng(seed: int) -> RngCap:
    import torch

    return RngCap._mint({"gen": torch.Generator().manual_seed(seed)})


def mint_metrics(sink: list) -> MetricsCap:
    return MetricsCap._mint(sink)
