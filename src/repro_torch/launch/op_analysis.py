"""Operator-level analysis of a traced program for the roofline, the
counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO of a compiled program. The port has
no compiler and no HLO: it runs the program once on tensors that hold no
data (``launch.programs``: meta tensors for the card's path) and reads
the operators it dispatches:

  * matmul FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, and the kernels' operators, which
    count their plain versions' FLOPs: ``kernels._flops``);
  * ``dot_bytes``, the operand and output bytes of those operators (an
    HBM traffic proxy, as in the reference);
  * the collectives that the program's ``shard_map`` cells issue
    (``distributed.spmd.observe``), with the reference's ring factors,
    per device, by operation and by the mesh axes they run over
    (``per_axes``): the cells of a call issue the same collectives, so
    the first cell's are counted;
  * each kernel operator's calls (``kernel_calls``);
  * the peak of the bytes of live tensor storages on the device of the
    program's largest argument, the arguments included: a storage
    counts from the operator that makes it until its last reference goes
    (a view, a tensor autograd saved), as the card's allocator holds it
    (without the allocator's rounding to 512-byte blocks). On the card's
    path (meta tensors) it adds, for the length of one operator, the
    scratch that some of PyTorch's CUDA kernels allocate out of the
    dispatcher's sight (``_card_scratch``).

There are no while-loop multipliers: the trace runs every layer and
microbatch. Elementwise FLOPs are not counted, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict

import torch
from torch._guards import detect_fake_mode
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import spmd
from repro_torch.kernels.flash_attention import ops as _flash  # noqa: F401
from repro_torch.kernels.ssd import ops as _ssd  # noqa: F401
from repro_torch.kernels.wkv6 import ops as _wkv6  # noqa: F401
from repro_torch.models import params as P

_aten = torch.ops.aten
# operator -> positions of its matrix operands
DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
        _aten.baddbmm: (1, 2)}
# the kernels' operators (registered by their ops modules, imported above)
KERNELS = ("flash_attention_fwd", "wkv6_chunked", "ssd_chunked")


def _wire_bytes(op: str, out_bytes: int, in_bytes: int, g: int) -> float:
    """Bytes one device sends for one collective over a group of ``g`` in
    a ring (the reference's ``hlo_analysis._wire_bytes``)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if op.startswith("all-reduce"):
        return 2.0 * out_bytes * frac
    if op.startswith("all-gather"):
        return out_bytes * frac
    if op.startswith("reduce-scatter"):
        return (in_bytes if in_bytes else out_bytes * g) * frac
    if op.startswith("all-to-all"):
        return out_bytes * frac
    if op.startswith("collective-permute"):
        return float(out_bytes)
    return 0.0


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _strided(t) -> int:
    return 0 if t.is_contiguous() else _bytes(t)


def _card_scratch(func, args, out) -> int:
    """Bytes that PyTorch's CUDA kernel for ``func`` allocates and frees
    within its launch, which no dispatch shows; the card showed each
    (the allocator's history of the VLM's cross attention backward and
    olmoe's prefill):

      * the softmaxes copy a strided input to a contiguous one, and the
        softmax backward first forms ``grad * output`` (in the operands'
        layout) and copies that too if it is strided (``SoftMax.cu``);
      * a sum or mean whose result type differs from its input's (a
        count of a boolean mask) first casts the whole input to it
        (``make_reduction_from_out_ty``; half or bf16 to float is read
        in place).
    """
    packet = func.overloadpacket
    if packet in (_aten._softmax, _aten._log_softmax):
        return _strided(args[0])
    if packet is _aten._log_softmax_backward_data:
        return _strided(args[0]) + _strided(args[1])
    if packet is _aten._softmax_backward_data:
        tmp = args[0] * args[1]  # a meta tensor: the layout, no data
        return _bytes(tmp) + _strided(tmp) + _strided(args[1])
    if packet in (_aten.sum, _aten.mean) and isinstance(out, torch.Tensor):
        x = args[0]
        if x.dtype != out.dtype and not (
                x.dtype in (torch.float16, torch.bfloat16)
                and out.dtype == torch.float32):
            return x.numel() * out.element_size()
    return 0


@dataclasses.dataclass
class Summary:
    dot_flops: float = 0.0
    dot_bytes: float = 0.0  # operand+output bytes of dots (HBM traffic proxy)
    collective_wire_bytes: float = 0.0
    collective_op_bytes: float = 0.0
    per_op: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # the same by the mesh axes each ran over ("all-reduce over model")
    per_axes: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


class _Ops(TorchDispatchMode):
    """Bytes of the dots and kernel operators, the kernels' calls and the
    live storages on ``device``."""

    def __init__(self, summary: Summary, device: torch.device):
        super().__init__()
        self.s = summary
        self._kernels = {getattr(torch.ops.repro_torch, k): k for k in KERNELS}
        self.device = device
        self.card = device.type == "meta"  # the card's path
        self.live: Dict[int, int] = {}  # storage -> bytes
        self.now = 0

    def track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = n = st.nbytes()
        self.now += n
        self.s.peak_bytes = max(self.s.peak_bytes, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in DOTS:
            self.s.dot_bytes += sum(_bytes(args[i]) for i in DOTS[packet]) \
                + _bytes(out)
        elif packet in self._kernels:
            name = self._kernels[packet]
            self.s.kernel_calls[name] = self.s.kernel_calls.get(name, 0) + 1
            self.s.dot_bytes += sum(map(_bytes, tree_leaves((args, kwargs,
                                                             out))))
        for t in tree_leaves(out):
            self.track(t)
        if self.card:
            self.s.peak_bytes = max(self.s.peak_bytes,
                                    self.now + _card_scratch(func, args,
                                                             out))
        return out

    def collective(self, op: str, out: torch.Tensor, g: int, cell: int, *,
                   axes, label):
        if cell != 0:  # every cell issues the same: count one device's
            return
        out_b = _bytes(out)
        wire = _wire_bytes(op, out_b, 0, g)
        self.s.collective_wire_bytes += wire
        self.s.collective_op_bytes += out_b
        d = self.s.per_op.setdefault(op, {"count": 0.0, "bytes": 0.0,
                                          "wire": 0.0, "one_cell_groups": 0})
        d["count"] += 1
        d["bytes"] += out_b
        d["wire"] += wire
        d["one_cell_groups"] += g <= 1  # a group of one sends nothing
        a = self.s.per_axes.setdefault(f"{op} over {','.join(axes)}",
                                       {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += out_b


def analyze(fn: Callable, *args) -> Summary:
    """Runs ``fn(*args)`` once, inside the fake mode of its arguments if
    they are fake tensors, and returns what it dispatched and the peak
    bytes of live storages on the device of the arguments' largest
    tensor."""
    leaves = [t for a in args for t in P.leaves(a)
              if isinstance(t, torch.Tensor)]
    summary = Summary()
    ops = _Ops(summary, max(leaves, key=_bytes).device)
    for t in leaves:
        ops.track(t)
    flops = FlopCounterMode(display=False)
    with contextlib.ExitStack() as stack:
        mode = detect_fake_mode(leaves)
        if mode is not None:
            stack.enter_context(mode)
        # the FLOP counter on top: it decomposes the composite operators
        # (inference mode dispatches ``matmul``, not ``mm``) into the ones
        # that the mode below it then sees
        stack.enter_context(ops)
        stack.enter_context(flops)
        stack.enter_context(spmd.observe(ops.collective))
        out = fn(*args)
        del out
    summary.dot_flops = float(flops.get_total_flops())
    return summary
