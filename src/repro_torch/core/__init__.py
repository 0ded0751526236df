# Bento core: the paper's primary contribution, on a PyTorch runtime.
#
#   interface.py  — typed module boundary (file-operations API, §4.3/4.4)
#   capability.py — unforgeable service handles (§4.6)
#   ownership.py  — borrow guards for host-side mutable state (§4.4)
#   services.py   — kernel services API, two bindings (§4.5, §4.9)
#   registry.py   — module registration + mount dispatch table (§4.2, §5.2)
#   upgrade.py    — online upgrade: quiesce/extract/migrate/restore (§4.8)

from repro_torch.core.capability import (BlockDeviceCap, Capability,
                                         CapabilityError, MeshCap, MetricsCap,
                                         RngCap, SuperBlockCap)
from repro_torch.core.interface import (Attr, BATCHABLE_OPS, BentoFilesystem,
                                        BentoModule, CompletionEntry, Errno,
                                        FileKind, FsError, ROOT_INO,
                                        SubmissionEntry)
from repro_torch.core.ownership import Borrow, BorrowError, Owned
from repro_torch.core.registry import (BentoQueue, Mount, OpGate, mount,
                                       register_bento)
from repro_torch.core.upgrade import UpgradeError, transfer_state, upgrade

__all__ = [
    "Attr", "BATCHABLE_OPS", "BentoFilesystem", "BentoModule", "BentoQueue",
    "BlockDeviceCap", "Borrow", "BorrowError", "Capability", "CapabilityError",
    "CompletionEntry", "Errno", "FileKind", "FsError", "MeshCap", "MetricsCap",
    "Mount", "OpGate", "ROOT_INO", "RngCap", "SubmissionEntry",
    "SuperBlockCap", "UpgradeError", "mount", "register_bento",
    "transfer_state", "upgrade",
]
