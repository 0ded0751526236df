from repro_torch.fs.blockdev import (BLOCK_SIZE, BlockDevice, FileBlockDevice,
                                     MemBlockDevice, TorchBlockDevice)
from repro_torch.fs.buffercache import BufferCache, BufferHead, BufferLeak
from repro_torch.fs.posix import PosixView

__all__ = [
    "BLOCK_SIZE", "BlockDevice", "BufferCache", "BufferHead", "BufferLeak",
    "FileBlockDevice", "MemBlockDevice", "PosixView", "TorchBlockDevice",
]
