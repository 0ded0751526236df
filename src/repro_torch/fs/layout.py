"""On-disk layout for the xv6-style file system (4 KiB blocks).

    [ 0 | superblock ]
    [ logstart .. logstart+nlog )        write-ahead journal
    [ inodestart .. bmapstart )          inode table
    [ bmapstart .. datastart )           block bitmap
    [ datastart .. size )                data blocks

Inodes carry 12 direct, 1 indirect and 1 double-indirect pointer (the
paper's 4 GB-file extension of stock xv6). Directory entries are fixed
64-byte records.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

BSIZE = 4096
FSMAGIC = 0x10203040
NDIRECT = 12
NINDIRECT = BSIZE // 4  # 1024 u32 pointers per block
MAXFILE_BLOCKS = NDIRECT + NINDIRECT + NINDIRECT * NINDIRECT  # ~4.2 GB

# inode: type u16, nlink u16, pad u32, size u64, addrs (NDIRECT+2) u32
_INODE_FMT = "<HHIQ" + "I" * (NDIRECT + 2)
INODE_SIZE = struct.calcsize(_INODE_FMT)  # 72 bytes
IPB = BSIZE // INODE_SIZE  # inodes per block

T_FREE, T_FILE, T_DIR = 0, 1, 2

DIRENT_SIZE = 64
NAME_MAX = DIRENT_SIZE - 4 - 1  # u32 ino + NUL

# Whiteout sentinel for overlay mounts (fs/overlay.py): a dirent whose ino
# field is this value records "NAME IS DELETED HERE" in a writable upper
# directory, masking a same-named entry in the immutable base below. Plain
# (non-overlay) mounts never create one; their namespace ops skip it like
# a hole but never REUSE its slot for a different name (the overlay's
# delete marker must not be silently evicted by an unrelated create).
WHITEOUT_INO = 0xFFFFFFFF  # u32 max — can never collide with a real ino


@dataclasses.dataclass
class SuperBlock:
    magic: int
    size: int  # total blocks
    nlog: int
    logstart: int
    ninodes: int
    inodestart: int
    bmapstart: int
    datastart: int

    _FMT = "<8I"

    def pack(self) -> bytes:
        raw = struct.pack(self._FMT, self.magic, self.size, self.nlog,
                          self.logstart, self.ninodes, self.inodestart,
                          self.bmapstart, self.datastart)
        return raw + b"\0" * (BSIZE - len(raw))

    @classmethod
    def unpack(cls, raw: bytes) -> "SuperBlock":
        vals = struct.unpack_from(cls._FMT, raw)
        return cls(*vals)


@dataclasses.dataclass
class DiskInode:
    type: int = T_FREE
    nlink: int = 0
    size: int = 0
    addrs: List[int] = dataclasses.field(
        default_factory=lambda: [0] * (NDIRECT + 2))

    def pack(self) -> bytes:
        return struct.pack(_INODE_FMT, self.type, self.nlink, 0, self.size,
                           *self.addrs)

    @classmethod
    def unpack(cls, raw: bytes, off: int = 0) -> "DiskInode":
        vals = struct.unpack_from(_INODE_FMT, raw, off)
        return cls(type=vals[0], nlink=vals[1], size=vals[3],
                   addrs=list(vals[4:]))


def pack_dirent(ino: int, name: str) -> bytes:
    nb = name.encode()
    assert 0 < len(nb) <= NAME_MAX, name
    return struct.pack("<I", ino) + nb + b"\0" * (DIRENT_SIZE - 4 - len(nb))


def unpack_dirent(raw: bytes, off: int):
    (ino,) = struct.unpack_from("<I", raw, off)
    name = raw[off + 4: off + DIRENT_SIZE].split(b"\0", 1)[0].decode()
    return ino, name


def geometry(n_blocks: int, ninodes: int = 4096, nlog: int = 64) -> SuperBlock:
    logstart = 1
    inodestart = logstart + nlog
    ninodeblocks = (ninodes + IPB - 1) // IPB
    bmapstart = inodestart + ninodeblocks
    nbmap = (n_blocks + BSIZE * 8 - 1) // (BSIZE * 8)
    datastart = bmapstart + nbmap
    return SuperBlock(FSMAGIC, n_blocks, nlog, logstart, ninodes,
                      inodestart, bmapstart, datastart)
