"""Cost analysis of a dispatch trace taken under ``FakeTensorMode`` (the
counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses the optimized HLO of a jitted step: it counts dot
FLOPs, fusion-boundary bytes and the collectives, each multiplied by the
trip count of the while loop around it.  An eager PyTorch step has no
HLO: :func:`analyze_trace` runs the step once on fake tensors (shapes
and dtypes, no data, no card) under a ``TorchDispatchMode`` and reads
every operator the dispatcher sees.  A host loop is unrolled by
construction, so nothing is scaled by a trip count; ``obs.loop_scope``
names the loop an op ran in.

* ``flops``: ``FlopCounterMode``'s count of the aten operators (the
  products);
* ``kernel_ops``: the operations of the kernel operators
  (``repro_torch::*``, their cost functions in ``kernels.cost``), by the
  rate they run at, and ``kernel_compute_s`` their time at those rates;
* ``bytes_accessed``: each op's operands and results (in eager PyTorch
  every op is a fusion boundary), a gather's or scatter's only the
  elements it picks, a kernel operator's bytes from its cost function;
  views and ``empty`` move nothing;
* ``launches``: kernel operator calls by the launch counter each adds to
  on the card (``kernel.<name>.launches``);
* ``peak_live_bytes``: the most bytes of storage alive at once (the
  arguments included), and ``argument_bytes`` / ``output_bytes``;
* ``collectives``: each ``c10d`` collective's op, reduction, dtype,
  shape, count and bytes, and the loop scope it ran in (``None``:
  outside every loop);
* ``host_reads``: ops that read a device value on the host
  (``.item()``, ``bool()``, a copy to the CPU), with their loop scope.
  On a fake tensor such a read raises ``DataDependentOutputException``;
  the analysis records it and the error;
* ``loop_writes``: every tensor an op inside a loop wrote
  (:class:`LoopWrite`): its results, and the arguments its schema
  mutates (the loop's state).

A build of PyTorch without CUDA can make fake ``cuda`` tensors, but a
few of its hand-written Python bindings (indexing, ``copy_``,
``contiguous``, ``~``, ``to``) take a CUDA
device guard and fail; while a trace runs on such a build, those
methods of a fake CUDA tensor are routed to the equivalent aten
operators (:class:`_FakeCudaShim`), which need no guard.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.cost import BF16_FLOPS, FP32_FLOPS, INT8_OPS, KERNEL_OPS, TF32_FLOPS
from ..obs import current_loops

__all__ = ["TraceAnalysis", "CollectiveRecord", "LoopWrite", "analyze_trace", "PEAK_NAMES"]

aten = torch.ops.aten
PEAK_NAMES = {FP32_FLOPS: "fp32", TF32_FLOPS: "tf32", BF16_FLOPS: "bf16", INT8_OPS: "int8"}
_REDUCE = {0: "sum", 1: "avg", 2: "product", 3: "min", 4: "max"}
_FREE = {
    "view", "_unsafe_view", "slice", "select", "unsqueeze", "squeeze", "expand", "t", "transpose", "permute",
    "as_strided", "alias", "detach", "reshape", "narrow", "unfold", "split", "split_with_sizes", "unbind",
    "chunk", "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_to_copy_meta", "diagonal", "view_as", "_reshape_alias", "lift_fresh_copy",
}
_HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero", "equal"}
# gathers read as many source elements as they write; scatters touch as
# many destination elements as they are given: neither reads the whole
# tensor it indexes
_GATHERS = {"index", "index_select", "gather", "take", "embedding"}
_SCATTERS = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_"}


@dataclass
class CollectiveRecord:
    op: str
    reduce: Optional[str]
    dtype: str
    shape: Tuple[int, ...]
    bytes: int
    loop: Optional[str]


@dataclass
class LoopWrite:
    """A tensor an op inside a loop wrote: a fresh result, or an
    argument it mutated in place (``in_place``: loop state)."""

    loop: str
    op: str
    shape: Tuple[int, ...]
    dtype: str
    in_place: bool


@dataclass
class TraceAnalysis:
    flops: float = 0.0
    kernel_ops: Dict[str, float] = field(default_factory=dict)
    kernel_compute_s: float = 0.0
    bytes_accessed: float = 0.0
    launches: Dict[str, int] = field(default_factory=dict)
    peak_live_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    collectives: List[CollectiveRecord] = field(default_factory=list)
    host_reads: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    loop_writes: List[LoopWrite] = field(default_factory=list)
    error: Optional[str] = None
    outputs: Any = None

    def collective_summary(self) -> Dict[str, Dict[str, int]]:
        """{"<op>.<reduce>.<dtype>[<shape>]@<loop>": {count, bytes}} plus
        "total"."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.collectives:
            key = f"{c.op}.{c.reduce or '-'}.{c.dtype}{list(c.shape)}@{c.loop or 'top'}"
            ent = out.setdefault(key, {"count": 0, "bytes": 0})
            ent["count"] += 1
            ent["bytes"] += c.bytes
        out["total"] = {"count": len(self.collectives), "bytes": sum(c.bytes for c in self.collectives)}
        return out

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in fields(self)
             if f.name not in ("outputs", "collectives", "loop_writes")}
        d["collectives"] = self.collective_summary()
        d["host_reads"] = [list(h) for h in self.host_reads]
        d["loop_writes"] = len(self.loop_writes)
        return d


def _tensors(tree) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        st = t.untyped_storage()
        return st._cdata, st.nbytes()
    except (RuntimeError, NotImplementedError):
        return id(t), _nbytes(t)


class _Live:
    """Bytes of storage alive, counted once per storage however many
    tensors (views) share it."""

    def __init__(self):
        self.refs: Dict[int, int] = defaultdict(int)
        self.size: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        key, nbytes = _storage_key(t)
        if key not in self.size:
            self.size[key] = nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        self.refs[key] -= 1
        if self.refs[key] == 0:
            del self.refs[key]
            self.live -= self.size.pop(key)


class _Recorder(TorchDispatchMode):
    def __init__(self, result: TraceAnalysis, live: _Live):
        super().__init__()
        self.r, self.live = result, live
        self.kernel_ops: Dict[float, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        short = name.split("::")[-1]
        loops = current_loops()
        loop = loops[-1] if loops else None
        if short in _HOST_READS or (short == "_to_copy" and kwargs.get("device") is not None
                                     and torch.device(kwargs["device"]).type == "cpu"
                                     and args and isinstance(args[0], torch.Tensor)
                                     and args[0].device.type != "cpu"):
            self.r.host_reads.append((str(func), loop))
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self.live.add(t)
        written = list(outs)
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write and i < len(args):
                written += [t for t in tree_flatten(args[i])[0] if isinstance(t, torch.Tensor)]
        if loop is not None:
            for i, t in enumerate(written):
                self.r.loop_writes.append(LoopWrite(loop, str(func.overloadpacket), tuple(t.shape),
                                                    str(t.dtype).split(".")[-1], i >= len(outs)))
        if name.startswith("c10d::"):
            self._collective(short, args, loop)
            return out
        spec = KERNEL_OPS.get(name)
        if spec is not None:
            cost = spec.cost(*args, **kwargs)
            key = spec.counter(*args, **kwargs)
            self.r.launches[key] = self.r.launches.get(key, 0) + 1
            self.kernel_ops[cost.peak] += cost.ops
            self.r.bytes_accessed += cost.bytes
            return out
        if short in _FREE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        if short in _GATHERS:  # the indices read, the rows they pick read and written
            self.r.bytes_accessed += sum(_nbytes(t) for t in ins[1:]) + 2 * sum(_nbytes(t) for t in outs)
        elif short in _SCATTERS:  # the indices and values read, as many destination elements written
            self.r.bytes_accessed += 2 * sum(_nbytes(t) for t in ins[1:])
        else:
            self.r.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out

    def _collective(self, short, args, loop):
        ts = [t for t in tree_flatten(args[0])[0] if isinstance(t, torch.Tensor)]
        reduce = None
        if short.startswith("allreduce"):
            reduce = _REDUCE.get(int(args[2].op()), "other")
        op = {"allreduce_": "all_reduce", "allgather_": "all_gather", "reduce_scatter_": "reduce_scatter",
              "alltoall_": "all_to_all", "broadcast_": "broadcast"}.get(short, short)
        src = ts[0] if op != "all_gather" else next(
            (t for t in tree_flatten(args[1])[0] if isinstance(t, torch.Tensor)), ts[0])
        self.r.collectives.append(CollectiveRecord(
            op, reduce, str(src.dtype).split(".")[-1], tuple(src.shape),
            sum(_nbytes(t) for t in ts), loop))


def _cuda_shim_needed() -> bool:
    return not torch.backends.cuda.is_built()


class _FakeCudaShim(TorchFunctionMode):
    """Indexing, ``copy_`` and ``contiguous`` of fake CUDA tensors through
    aten operators, for a build of PyTorch without CUDA (module
    docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if args and isinstance(args[0], torch.Tensor) and args[0].device.type == "cuda":
            if func is torch.Tensor.__getitem__:
                return _getitem(args[0], args[1])
            if func is torch.Tensor.__setitem__:
                return _setitem(args[0], args[1], args[2])
            if func is torch.Tensor.copy_:
                return aten.copy_.default(args[0], args[1], kwargs.get("non_blocking", False))
            if func is torch.Tensor.contiguous:
                t = args[0]
                return t if t.is_contiguous() else aten.clone.default(t, memory_format=torch.contiguous_format)
            if func is torch.Tensor.__invert__:
                return aten.bitwise_not.default(args[0])
            if func is torch.Tensor.to:
                return _to(args[0], *args[1:], **kwargs)
        return func(*args, **kwargs)


def _to(t, *args, **kwargs):
    device, dtype, non_blocking, _ = torch._C._nn._parse_to(*args, **kwargs)
    if device is not None and device.type != t.device.type:
        return aten._to_copy.default(t, dtype=dtype or t.dtype, device=device)
    return t if dtype is None or dtype == t.dtype else aten._to_copy.default(t, dtype=dtype)


def _split_index(x: torch.Tensor, idx):
    """Basic indexing (ints, slices, None, Ellipsis) applied as views, and
    the tensor indices left for ``aten.index`` by dimension."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    used = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out, dim, tensors = x, 0, {}
    for i in idx:
        if i is None:
            out = aten.unsqueeze.default(out, dim)
            dim += 1
        elif i is Ellipsis:
            dim += x.dim() - used
        elif isinstance(i, bool):
            raise TypeError("boolean scalar indices are not supported in a trace")
        elif isinstance(i, int):
            out = aten.select.int(out, dim, i)
        elif isinstance(i, slice):
            out = aten.slice.Tensor(out, dim, i.start, i.stop, i.step or 1)
            dim += 1
        elif isinstance(i, torch.Tensor):
            tensors[dim] = i
            dim += 1
        else:
            raise TypeError(f"unsupported index {type(i).__name__} in a trace")
    return out, tensors


def _getitem(x, idx):
    out, tensors = _split_index(x, idx)
    if not tensors:
        return out
    return aten.index.Tensor(out, [tensors.get(k) for k in range(max(tensors) + 1)])


def _setitem(x, idx, value):
    out, tensors = _split_index(x, idx)
    if not isinstance(value, torch.Tensor):
        if not tensors:
            aten.fill_.Scalar(out, value)
            return None
        value = torch.tensor(value, dtype=x.dtype, device=x.device)
    if tensors:
        aten.index_put_.default(out, [tensors.get(k) for k in range(max(tensors) + 1)], value)
    else:
        aten.copy_.default(out, value)
    return None


def analyze_trace(fn, *args, **kwargs) -> TraceAnalysis:
    """Run ``fn(*args, **kwargs)`` once on the fake tensors it is given
    (their ``FakeTensorMode`` is entered) and return its
    :class:`TraceAnalysis` (module docstring), its outputs in
    ``.outputs``.  A host read of a device value ends the trace: its
    ``error`` names it."""
    from torch._guards import detect_fake_mode
    from torch.utils.flop_counter import FlopCounterMode

    ins = _tensors((args, kwargs))
    mode = detect_fake_mode(tuple(ins))
    if mode is None:
        raise ValueError("analyze_trace runs on fake tensors (made in a FakeTensorMode)")
    result = TraceAnalysis()
    live = _Live()
    seen = set()
    for t in ins:
        key, nbytes = _storage_key(t)
        if key not in seen:
            seen.add(key)
            result.argument_bytes += nbytes
        live.add(t)
    rec = _Recorder(result, live)
    flop_mode = FlopCounterMode(display=False)
    shim = _FakeCudaShim() if _cuda_shim_needed() else None
    try:
        with mode, flop_mode, rec:
            if shim is not None:
                with shim:
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - a failed trace is reported, not raised
        from torch._subclasses.fake_tensor import DataDependentOutputException

        if not isinstance(exc, DataDependentOutputException):
            raise
        result.error = f"{type(exc).__name__}: {exc}"
        out = None
    result.outputs = out
    result.output_bytes = sum(_nbytes(t) for t in _tensors(out)) if out is not None else 0
    result.flops = float(flop_mode.get_total_flops())
    result.kernel_ops = {PEAK_NAMES.get(p, str(p)): v for p, v in rec.kernel_ops.items()}
    result.kernel_compute_s = sum(v / p for p, v in rec.kernel_ops.items())
    result.peak_live_bytes = live.peak
    return result
