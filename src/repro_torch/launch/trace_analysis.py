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

* ``flops``: the aten operators' FLOPs by ``FlopCounterMode``'s
  registry (the products), counted on each rank's local operands;
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
  arguments included), ``peak_storages`` the largest storages alive
  then (bytes, the op that made it or ``"argument"``, its shape and
  dtype), and ``argument_bytes`` / ``output_bytes``;
  ``output_fresh_bytes``: the outputs' bytes whose storage is not an
  argument's (a step that updates its parameters and optimizer state in
  place returns them at no fresh byte);
* ``collectives``: each collective's op, reduction, dtype, shape,
  count and bytes, and the loop scope it ran in (``None``: outside
  every loop): the ``c10d`` ops a process group runs, and the
  functional collectives (``_c10d_functional``: all-gather,
  reduce-scatter, all-reduce, all-to-all) that DTensor's
  redistributions issue, their bytes the output's (the reference's
  output-size proxy);
* ``host_reads``: ops that read a device value on the host
  (``.item()``, ``bool()``, a copy to the CPU), with their loop scope.
  On a fake tensor such a read raises ``DataDependentOutputException``;
  the analysis records it and the error;
* ``ops``: the recorded ops by name, and ``foreign_ops`` the ops left
  out as DTensor's shape propagation (below), by name: what tells two
  PyTorch versions' traces of one step apart;
* ``loop_writes``: every tensor an op inside a loop wrote
  (:class:`LoopWrite`): its results, and the arguments its schema
  mutates (the loop's state).

DTensor steps: the dispatcher hands an op on DTensors to the recorder
first; the recorder passes it on (``NotImplemented``), and DTensor's own
dispatch issues the local ops on each rank's shards and the functional
collectives of its redistributions, which the recorder reads as any
other.  The ops DTensor runs to propagate shapes are not the step's and
are left out: those it runs inside its sharding propagator
(``_PROPAGATION``: on global shapes; torch 2.13 decomposes an op such as
``matmul`` there and runs the pieces on plain ``meta`` tensors of the
global shapes, which a ``meta`` trace cannot tell from its own by the
tensors alone), and any op on another fake mode's tensors.  Autograd's backward and
``torch.utils.checkpoint``'s recomputation dispatch their ops into the
same trace (the recomputed forward counted again, as the card runs it).

Fake tensors or ``meta`` tensors: a trace runs on fake tensors of a
``FakeTensorMode`` (the cluster cells: fake CUDA tensors) or on plain
``meta`` tensors (the model cells: a CPU-only build aborts in autograd
on a fake CUDA tensor, whose input metadata asks for CUDA's device
guard).  The kernel wrappers route a ``meta`` tensor to their operators
as they route a CUDA one, so both traces take the launch path.  A host
read of a CPU tensor (the optimizer's step count, a decode position) is
a host value, not a device read, and is not recorded.

A build of PyTorch without CUDA can make fake ``cuda`` tensors (the
cluster cells' traces; the model cells' ``meta`` tensors need no shim),
but a few of its hand-written Python bindings (indexing, ``copy_``,
``contiguous``, ``~``, ``to``) take a CUDA
device guard and fail; while a trace runs on such a build, those
methods of a fake CUDA tensor are routed to the equivalent aten
operators (:class:`_FakeCudaShim`), which need no guard.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

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
# composite ops that return their input as it is when nothing changes
# (with autograd's keys excluded, as under ``inference_mode``, composite
# ops reach the recorder whole)
_MAYBE_SAME = {"to", "contiguous"}


def _matmul_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """``matmul`` (composite: it reaches the recorder whole where
    autograd's keys are excluded): 2 FLOP an output element and a
    contracted one."""
    return 2 * out_val.numel() * a.shape[-1]


_FLOPS = {torch.ops.aten.matmul: _matmul_flops}
# DTensor's functional collectives (``_c10d_functional`` and their autograd
# twins); wait and wrap ops move nothing
_FUNCTIONAL = {"all_gather_into_tensor": "all_gather", "reduce_scatter_tensor": "reduce_scatter",
               "all_reduce": "all_reduce", "all_to_all_single": "all_to_all", "broadcast": "broadcast"}
# gathers read as many source elements as they write; scatters touch as
# many destination elements as they are given: neither reads the whole
# tensor it indexes
_GATHERS = {"index", "index_select", "gather", "take", "embedding"}
_SCATTERS = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_"}


# records are named tuples of immutable fields (a model cell's trace keeps
# millions of them; the garbage collector stops tracking such tuples)


class CollectiveRecord(NamedTuple):
    op: str
    reduce: Optional[str]
    dtype: str
    shape: Tuple[int, ...]
    bytes: int
    loop: Optional[str]


class LoopWrite(NamedTuple):
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
    peak_storages: List[list] = field(default_factory=list)
    ops: Dict[str, int] = field(default_factory=dict)
    foreign_ops: Dict[str, int] = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    output_fresh_bytes: int = 0
    collectives: List[CollectiveRecord] = field(default_factory=list)
    host_reads: List[Tuple[str, Optional[str]]] = field(default_factory=list)
    loop_writes: List[LoopWrite] = field(default_factory=list)
    error: Optional[str] = None
    outputs: Any = None
    # (shape, dtype) of every tensor a collective returned, and of every
    # other op's result (views excluded) with the ops that returned it:
    # what the dry run's check of whole weights reads
    collective_shapes: set = field(default_factory=set)
    op_shapes: Dict[tuple, set] = field(default_factory=dict)

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
             if f.name not in ("outputs", "collectives", "loop_writes", "collective_shapes", "op_shapes")}
        d["collectives"] = self.collective_summary()
        d["host_reads"] = [list(h) for h in self.host_reads]
        d["loop_writes"] = len(self.loop_writes)
        return d


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree (a module's parameters and buffers; a
    DTensor's local shard)."""
    leaves, _ = tree_flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            out.extend(_tensors(list(x.parameters()) + list(x.buffers())))
        elif isinstance(x, torch.Tensor):
            out.append(x.to_local() if _is_dtensor(x) else x)
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
    tensors (views) share it; at the peak (within 1%), the largest
    storages alive and what made them."""

    TOP = 8

    def __init__(self):
        self.refs: Dict[int, int] = defaultdict(int)
        self.size: Dict[int, int] = {}
        self.made: Dict[int, tuple] = {}
        self.live = 0
        self.peak = 0
        self.at_peak: List[list] = []
        self._shot = 0

    def add(self, t: torch.Tensor, made_by: str = "argument") -> None:
        key, nbytes = _storage_key(t)
        if key not in self.size:
            self.size[key] = nbytes
            self.made[key] = (made_by, list(t.shape), str(t.dtype).split(".")[-1])
            self.live += nbytes
            if self.live > self.peak:
                self.peak = self.live
                if self.peak > 1.01 * self._shot:
                    self._shot = self.peak
                    top = sorted(self.size, key=self.size.get, reverse=True)[: self.TOP]
                    self.at_peak = [[self.size[k], *self.made[k]] for k in top]
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        self.refs[key] -= 1
        if self.refs[key] == 0:
            del self.refs[key]
            del self.made[key]
            self.live -= self.size.pop(key)


class _Recorder(TorchDispatchMode):
    def __init__(self, result: TraceAnalysis, live: _Live, mode):
        super().__init__()
        self.r, self.live, self.mode = result, live, mode
        self.kernel_ops: Dict[float, float] = defaultdict(float)
        self.propagating = 0  # depth of DTensor's shape propagation (``_dtensor_propagation``)

    def _foreign(self, tensors) -> bool:
        """Whether an op is DTensor's shape propagation, not the step's:
        run inside the propagator, or on another fake mode's tensors."""
        from torch._subclasses.fake_tensor import FakeTensor

        return self.propagating > 0 or any(isinstance(t, FakeTensor) and t.fake_mode is not self.mode
                                           for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_flatten((args, kwargs))[0]
        if any(_is_dtensor(a) for a in leaves):
            return NotImplemented  # DTensor's dispatch issues the local ops and collectives, which come back here
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        name = func._schema.name
        short = name.split("::")[-1]
        if self._foreign(ins):
            self.r.foreign_ops[short] = self.r.foreign_ops.get(short, 0) + 1
            return func(*args, **kwargs)
        loops = current_loops()
        loop = loops[-1] if loops else None
        first = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if first is not None and first.device.type != "cpu" and (
                short in _HOST_READS or (short == "_to_copy" and kwargs.get("device") is not None
                                         and torch.device(kwargs["device"]).type == "cpu")):
            self.r.host_reads.append((str(func), loop))
            if first.device.type == "meta":  # a meta tensor has no value: the trace stops as a fake one's does
                from torch._subclasses.fake_tensor import DataDependentOutputException

                raise DataDependentOutputException(func)
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self._foreign(outs):
            self.r.foreign_ops[short] = self.r.foreign_ops.get(short, 0) + 1
            return out
        self.r.ops[short] = self.r.ops.get(short, 0) + 1
        for t in outs:
            self.live.add(t, short)
        written = list(outs)
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write and i < len(args):
                written += [t for t in tree_flatten(args[i])[0] if isinstance(t, torch.Tensor)]
        if loop is not None:
            for i, t in enumerate(written):
                self.r.loop_writes.append(LoopWrite(loop, str(func.overloadpacket), tuple(t.shape),
                                                    str(t.dtype).split(".")[-1], i >= len(outs)))
        if name.startswith("c10d::") or name.startswith("_c10d_functional"):
            self.r.collective_shapes.update((tuple(t.shape), str(t.dtype).split(".")[-1]) for t in outs)
            if name.startswith("c10d::"):
                self._collective(short, args, loop)
            else:
                self._functional(short, args, outs, loop)
            return out
        if short not in _FREE:
            for t in outs:
                self.r.op_shapes.setdefault((tuple(t.shape), str(t.dtype).split(".")[-1]), set()).add(short)
        spec = KERNEL_OPS.get(name)
        if spec is not None:
            cost = spec.cost(*args, **kwargs)
            key = spec.counter(*args, **kwargs)
            self.r.launches[key] = self.r.launches.get(key, 0) + 1
            self.kernel_ops[cost.peak] += cost.ops
            self.r.bytes_accessed += cost.bytes
            return out
        if short in _MAYBE_SAME and all(any(o is i for i in ins) for o in outs):
            return out
        flop_fn = flop_registry.get(func.overloadpacket) or _FLOPS.get(func.overloadpacket)
        if flop_fn is not None:
            self.r.flops += flop_fn(*args, **kwargs, out_val=out)
        if short in _FREE:
            return out
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

    def _functional(self, short, args, outs, loop):
        op = _FUNCTIONAL.get(short.split(".")[0])
        if op is None or not outs:  # wait_tensor, the autograd wrap: nothing moves
            return
        reduce = None
        if op in ("all_reduce", "reduce_scatter"):
            reduce = str(args[1]).lower()
        src = args[0]
        self.r.collectives.append(CollectiveRecord(
            op, reduce, str(src.dtype).split(".")[-1], tuple(src.shape), sum(_nbytes(t) for t in outs), loop))


_PROPAGATION = ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def _dtensor_propagation(rec: _Recorder):
    """``rec.propagating`` above 0 while DTensor's sharding propagator
    runs (``_PROPAGATION``, where this version has them): it runs ops, or
    an op's decomposition, on global shapes to choose the placements and
    derive the output's metadata."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    origs = {name: getattr(ShardingPropagator, name) for name in _PROPAGATION if hasattr(ShardingPropagator, name)}

    def flagged(orig):
        def propagate(self, *args, **kwargs):
            rec.propagating += 1
            try:
                return orig(self, *args, **kwargs)
            finally:
                rec.propagating -= 1
        return propagate

    for name, orig in origs.items():
        setattr(ShardingPropagator, name, flagged(orig))
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(ShardingPropagator, name, orig)


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
    (their ``FakeTensorMode`` is entered) or on ``meta`` tensors, and
    return its :class:`TraceAnalysis` (module docstring), its outputs in
    ``.outputs``.  A host read of a device value ends the trace: its
    ``error`` names it."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import DataDependentOutputException

    ins = _tensors((args, kwargs))
    mode = detect_fake_mode(tuple(ins))
    if mode is None and not any(t.device.type == "meta" for t in ins):
        raise ValueError("analyze_trace runs on fake tensors (made in a FakeTensorMode) or on meta tensors")
    result = TraceAnalysis()
    live = _Live()
    seen = set()
    for t in ins:
        key, nbytes = _storage_key(t)
        if key not in seen:
            seen.add(key)
            result.argument_bytes += nbytes
        live.add(t)
    rec = _Recorder(result, live, mode)
    shim = _FakeCudaShim() if _cuda_shim_needed() and mode is not None else None
    try:
        with mode if mode is not None else contextlib.nullcontext(), rec, shim or contextlib.nullcontext(), \
                _dtensor_propagation(rec):
            out = fn(*args, **kwargs)
    except DataDependentOutputException as exc:  # a failed trace is reported, not raised
        result.error = f"{type(exc).__name__}: {exc}"
        out = None
    result.outputs = out
    outs = _tensors(out) if out is not None else []
    fresh = {}
    for t in outs:
        key, nbytes = _storage_key(t)
        if key not in seen:
            fresh[key] = nbytes
    result.output_bytes = sum(_nbytes(t) for t in outs)
    result.output_fresh_bytes = sum(fresh.values())
    result.kernel_ops = {PEAK_NAMES.get(p, str(p)): v for p, v in rec.kernel_ops.items()}
    result.kernel_compute_s = sum(v / p for p, v in rec.kernel_ops.items())
    result.peak_live_bytes = live.peak
    result.peak_storages = live.at_peak
    return result
