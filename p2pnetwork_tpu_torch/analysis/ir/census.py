"""graftaudit's census: what one run of a lowering asks of torch.

The reference audits the jaxpr its lowerings trace to. The port runs eager
torch and has no program to read, so the census watches one concrete run
instead, at the function level (``torch.overrides.TorchFunctionMode``):
the torch calls the port's code makes, by name, not the aten ops torch
decomposes them into, so the count does not drift with torch's
decompositions. It records:

- ``calls``: every torch call that returns a tensor, by name
  (``torch.zeros``, ``Tensor.index_add_``, ...);
- ``kernels``: each hand-written kernel's wrapper (``_device.kernel``) as
  its launches under the kernel's name, whichever twin runs; the calls of
  the plain twin are not counted, so the census is the same on the CPU
  and on the card;
- ``bytes``: the bytes of the tensor operands and results of every
  counted call and kernel;
- ``reads``: host reads of device tensors (``item``, ``bool``/``int``/
  ``float``, ``tolist``, ``numpy``, ``cpu``, the calls whose output size
  depends on the data: ``nonzero``, ``unique``, ``masked_select``,
  boolean indexing), each a device->host sync on the card; ``declared``
  counts those made under ``_device.counted_syncs`` (the engine loops'
  exit reads), the rest are ``undeclared``;
- ``uploads``: host->device copies (``torch.tensor``/``as_tensor`` of host
  data onto the device, ``.to(device)`` of a host tensor, a host value
  written into a device tensor by ``x[i] = v``), each a sync on the card
  too (a pageable copy waits for its stream);
- ``f64``: calls that make a float64 device tensor, and ``f64_widen``
  those of them with no float64 operand (where the widening starts);
- ``slots``: the largest index operand of a gather or scatter call
  (``__getitem__``/``index_select``/``gather``/``scatter*``/
  ``index_add_``/``index_put_``/``index_fill_``), which the frontier slot
  rule reads.

A tensor is a HOST tensor when it came from ``cpu()``/``numpy``, from
numpy, or from a creation call with no ``device=``, or when every tensor
it was computed from is one; reads of host tensors are not syncs. On the
CPU this provenance stands in for the card's devices.

:class:`LiveTracker` (a ``TorchDispatchMode``) keeps the bytes of the
storages the run allocates that are still alive after each aten op; its
peak is the memory ratchet's number (``memory.py``) and the carry audit's
(``donation.py``). Inside a kernel wrapper it counts only the wrapper's
outputs, as the census counts only its launches.

Nothing here imports torch until a census starts: the package stays
importable without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

__all__ = ["Census", "CensusRecord", "LiveTracker", "run_census",
           "call_name", "READ_CALLS", "DATA_DEPENDENT_CALLS"]

#: Calls that read a tensor's values on the host.
READ_CALLS = frozenset({
    "Tensor.item", "Tensor.tolist", "Tensor.numpy", "Tensor.__bool__",
    "Tensor.__int__", "Tensor.__float__", "Tensor.__index__",
    "Tensor.__array__", "Tensor.cpu",
})
#: Calls whose output size depends on the data: the card must tell the
#: host how much it made before the host can go on.
DATA_DEPENDENT_CALLS = frozenset({
    "torch.nonzero", "Tensor.nonzero", "torch.argwhere", "Tensor.argwhere",
    "torch.unique", "Tensor.unique", "torch.unique_consecutive",
    "Tensor.unique_consecutive", "torch.masked_select",
    "Tensor.masked_select", "torch.bincount", "Tensor.bincount",
})
#: Calls that move indexed slots (gathers and scatters).
_SLOT_CALLS = frozenset({
    "Tensor.__getitem__", "Tensor.__setitem__", "torch.index_select",
    "Tensor.index_select", "torch.gather", "Tensor.gather", "torch.take",
    "Tensor.scatter", "Tensor.scatter_", "Tensor.scatter_add",
    "Tensor.scatter_add_", "Tensor.scatter_reduce", "Tensor.scatter_reduce_",
    "torch.scatter", "torch.scatter_add", "torch.scatter_reduce",
    "Tensor.index_add", "Tensor.index_add_", "torch.index_add",
    "Tensor.index_put", "Tensor.index_put_", "torch.index_put",
    "Tensor.index_fill", "Tensor.index_fill_", "Tensor.index_copy_",
})
#: Creation calls: a host tensor unless given a device.
_CREATE_CALLS = frozenset({
    "torch.tensor", "torch.as_tensor", "torch.zeros", "torch.ones",
    "torch.full", "torch.empty", "torch.arange", "torch.linspace",
    "torch.eye", "torch.rand", "torch.randn", "torch.randint",
})
_HOST_RESULT_CALLS = frozenset({"Tensor.cpu", "Tensor.numpy",
                                "torch.from_numpy"})


def call_name(func) -> str:
    """The census name of a torch callable: ``Tensor.x`` for a tensor
    method or property, ``torch.x`` for a function of the ``torch``
    namespace, else ``module.x``."""
    qual = getattr(func, "__qualname__", "") or ""
    name = getattr(func, "__name__", "") or qual
    if qual.startswith(("TensorBase.", "Tensor.", "_TensorBase.")):
        return "Tensor." + name
    if qual.startswith("_VariableFunctionsClass."):
        return "torch." + name
    if qual.startswith(("getset_descriptor.", "method-wrapper")) or \
            name == "__get__":
        owner = getattr(func, "__self__", None)
        return "Tensor." + str(getattr(owner, "__name__", "attr"))
    module = getattr(func, "__module__", None) or "torch"
    if module in ("torch.functional", "torch._C._VariableFunctions",
                  "torch._tensor"):
        module = "torch"
    return f"{module}.{name}"


@dataclasses.dataclass
class CensusRecord:
    """What one run asked of torch (module doc)."""

    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: int = 0
    reads: Dict[str, int] = dataclasses.field(default_factory=dict)
    declared: int = 0
    undeclared: Dict[str, int] = dataclasses.field(default_factory=dict)
    uploads: int = 0
    f64: Dict[str, int] = dataclasses.field(default_factory=dict)
    f64_widen: Dict[str, int] = dataclasses.field(default_factory=dict)
    slots: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def launches(self) -> int:
        """Tensor-producing calls plus kernel launches."""
        return sum(self.calls.values()) + sum(self.kernels.values())

    @property
    def syncs(self) -> int:
        """Host reads of device tensors."""
        return sum(self.reads.values())

    def to_json(self) -> dict:
        return {"launches": self.launches,
                "calls": dict(sorted(self.calls.items())),
                "kernels": dict(sorted(self.kernels.items())),
                "bytes": self.bytes, "syncs": self.syncs,
                "reads": dict(sorted(self.reads.items())),
                "declared": self.declared,
                "undeclared": dict(sorted(self.undeclared.items())),
                "uploads": self.uploads,
                "f64": dict(sorted(self.f64.items())),
                "f64_widen": dict(sorted(self.f64_widen.items())),
                "slots": dict(sorted(self.slots.items()))}


def _tensors(obj, out: list) -> list:
    """Every tensor in ``obj`` (nested tuples, lists and dicts)."""
    import torch

    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Census:
    """Records one run (module doc). Use through :func:`run_census`.

    ``log=True`` also keeps every counted call's operand and result
    tensors' identities and bytes, in order, for the analytic liveness
    walk of ``memory.py``."""

    def __init__(self, device, log: bool = False):
        import torch
        from torch.utils.weak import WeakIdKeyDictionary

        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.record = CensusRecord()
        self.suspended = 0
        self._declared = 0
        self._host = WeakIdKeyDictionary()
        self.log: Optional[List[tuple]] = [] if log else None
        self._mode = None
        self.tracker: Optional[LiveTracker] = None

    # ------------------------------------------------------------ hooks

    @contextlib.contextmanager
    def declared(self):
        """Host reads made in the block are declared (counted syncs)."""
        self._declared += 1
        try:
            yield
        finally:
            self._declared -= 1

    def kernel(self, name: str, launches: int, fn, args, kwargs):
        """One call of a kernel wrapper: ``launches`` launches of
        ``name``, its operand and result bytes; nothing inside counted."""
        rec = self.record
        if self.suspended:
            return fn(*args, **kwargs)
        self.suspended += 1
        tracker = self.tracker
        if tracker is not None:
            tracker.suspended += 1
        try:
            out = fn(*args, **kwargs)
            rec.kernels[name] = rec.kernels.get(name, 0) + launches
            ins, outs = _tensors((args, kwargs), []), _tensors(out, [])
            rec.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if tracker is not None:
                tracker.adopt(outs)
            if self.log is not None:
                self.log.append((f"kernel:{name}", _keys(ins), _keys(outs)))
        finally:
            self.suspended -= 1
            if tracker is not None:
                tracker.suspended -= 1
        return out

    # ------------------------------------------------------------ calls

    def is_host(self, t) -> bool:
        return t.device != self.device or t in self._host

    def _provenance(self, name, self_t, ins, args, kwargs):
        """``(host, upload)`` of a call's results: whether they are host
        tensors, and whether the call copied host data to the device."""
        if name in _HOST_RESULT_CALLS:
            return True, False
        if name in ("Tensor.to", "Tensor.cuda") and self_t is not None:
            target = "cuda" if name == "Tensor.cuda" else \
                _target_device(args[1:], kwargs)
            if target is None:
                return self.is_host(self_t), False
            if target != self.device.type:
                return True, False
            return False, self.is_host(self_t)
        if "device" in kwargs:
            target = _target_device((), kwargs)
            if target != self.device.type:
                return True, False
            data = ins[0] if ins else None
            upload = name in ("torch.tensor", "torch.as_tensor") and (
                data is None or self.is_host(data))
            return False, upload
        if name in _CREATE_CALLS:
            return not any(not self.is_host(a) for a in ins), False
        if name == "Tensor.copy_" and len(ins) > 1:
            return self.is_host(ins[0]), (not self.is_host(ins[0])
                                          and self.is_host(ins[1]))
        return bool(ins) and all(self.is_host(a) for a in ins), False

    def on_call(self, func, args, kwargs, out) -> None:
        import torch

        name = call_name(func)
        if name.startswith("torch._ops."):
            # An aten op torch calls itself (``lift_fresh`` under a
            # dispatch mode): not a call of the port's code.
            return
        rec = self.record
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        self_t = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        # Host reads.
        read = None
        if name in READ_CALLS and self_t is not None:
            read = name
        elif name in DATA_DEPENDENT_CALLS and ins:
            read = name
        elif name == "torch.where" and len(args) == 1 and not kwargs:
            read = "torch.where(cond)"
        elif name in ("Tensor.__getitem__", "Tensor.__setitem__") and \
                len(args) > 1 and _has_bool_index(args[1]):
            read = f"{name}[bool]"
        elif name == "Tensor.to" and self_t is not None and \
                _target_device(args[1:], kwargs) == "cpu" and \
                self.device.type != "cpu":
            # On the CPU a move to the CPU is the trace device's own (the
            # graph's ``.to(device)``): only ``cpu()`` shows as a read.
            read = "Tensor.to(cpu)"
        if read is not None and (self_t if self_t is not None else ins[0]) \
                is not None:
            src = self_t if self_t is not None else ins[0]
            if not self.is_host(src):
                rec.reads[read] = rec.reads.get(read, 0) + 1
                if self._declared:
                    rec.declared += 1
                else:
                    rec.undeclared[read] = rec.undeclared.get(read, 0) + 1
        if name == "Tensor.__setitem__" and self_t is not None and \
                len(args) > 2 and not self.is_host(self_t) and not (
                    isinstance(args[2], torch.Tensor)
                    and not self.is_host(args[2])):
            # A host value written into a device tensor: a copy up.
            rec.uploads += 1
        if not outs:
            return
        host, upload = self._provenance(name, self_t, ins, args, kwargs)
        if host:
            for t in outs:
                self._host[t] = True
            return
        if upload:
            rec.uploads += 1
        rec.calls[name] = rec.calls.get(name, 0) + 1
        rec.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if any(t.dtype == torch.float64 for t in outs):
            rec.f64[name] = rec.f64.get(name, 0) + 1
            if not any(a.dtype == torch.float64 for a in ins):
                rec.f64_widen[name] = rec.f64_widen.get(name, 0) + 1
        if name in _SLOT_CALLS:
            idx = [a for a in ins[1:] if not a.is_floating_point()
                   and a.dtype != torch.bool]
            if idx:
                n = max(a.numel() for a in idx)
                rec.slots[name] = max(rec.slots.get(name, 0), n)
        if self.log is not None:
            self.log.append((name, _keys(ins), _keys(outs)))


def _keys(ts) -> list:
    """``(storage key, bytes)`` of each tensor: the storage it views."""
    out = []
    for t in ts:
        try:
            key = t.untyped_storage().data_ptr() or id(t)
        except (RuntimeError, NotImplementedError):
            key = id(t)
        out.append((key, _nbytes(t)))
    return out


def _has_bool_index(idx) -> bool:
    import torch

    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


def _target_device(args, kwargs) -> Optional[str]:
    import torch

    cand = kwargs.get("device")
    if cand is None:
        for a in args:
            if isinstance(a, (str, torch.device)):
                cand = a
                break
    if cand is None:
        return None
    try:
        return torch.device(cand).type
    except (RuntimeError, TypeError):
        return None


def _function_mode(census: Census):
    from torch.overrides import TorchFunctionMode

    class _Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not census.suspended:
                census.on_call(func, args, kwargs, out)
            return out

    return _Mode()


class LiveTracker:
    """Live bytes of the storages a run allocates, after each aten op
    (module doc). ``peak`` is their most; ``live`` what is alive now.
    Storages that existed before the run are not counted."""

    def __init__(self):
        self.live_refs: Dict[int, tuple] = {}
        self.pre: Dict[int, object] = {}
        self.live = 0
        self.peak = 0
        self.suspended = 0
        self._mode = None

    def _add(self, t) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        try:
            storage = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        ref = StorageWeakRef(storage)
        key = ref.cdata
        if key in self.live_refs:
            return
        old = self.pre.get(key)
        if old is not None and not old.expired():
            return
        nbytes = storage.nbytes()
        self.live_refs[ref.cdata] = (ref, nbytes)
        self.live += nbytes

    def preexisting(self, tensors) -> None:
        """Mark the storages of ``tensors`` as not the run's."""
        from torch.multiprocessing.reductions import StorageWeakRef

        for t in tensors:
            try:
                ref = StorageWeakRef(t.untyped_storage())
            except (RuntimeError, NotImplementedError):
                continue
            self.pre[ref.cdata] = ref

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live_refs.items() if ref.expired()]
        for k in dead:
            self.live -= self.live_refs.pop(k)[1]

    def adopt(self, outs) -> None:
        """Count a kernel wrapper's results as allocated now."""
        for t in outs:
            self._add(t)
        self._sweep()
        self.peak = max(self.peak, self.live)

    def on_op(self, out) -> None:
        for t in _tensors(out, []):
            self._add(t)
        self.peak = max(self.peak, self.live)
        self._sweep()

    def bytes_of(self, tensors) -> int:
        """Bytes of the run's live storages among ``tensors``' storages."""
        from torch.multiprocessing.reductions import StorageWeakRef

        seen, total = set(), 0
        for t in tensors:
            key = StorageWeakRef(t.untyped_storage()).cdata
            if key in self.live_refs and key not in seen:
                seen.add(key)
                total += self.live_refs[key][1]
        return total


def _dispatch_mode(tracker: LiveTracker):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not tracker.suspended:
                tracker.on_op(out)
            return out

    return _Mode()


@contextlib.contextmanager
def run_census(device, *, track: bool = False, log: bool = False,
               inputs=()):
    """Record the torch calls of the block into a :class:`Census` (and,
    with ``track``, its live storages into ``census.tracker``, the
    storages of ``inputs`` excluded). One census at a time."""
    from p2pnetwork_tpu_torch import _device

    if _device.CENSUS is not None:
        raise RuntimeError("a census is already running")
    census = Census(device, log=log)
    stack = contextlib.ExitStack()
    if track:
        census.tracker = LiveTracker()
        census.tracker.preexisting(_tensors(inputs, []))
        stack.enter_context(_dispatch_mode(census.tracker))
    _device.CENSUS = census
    try:
        with stack, _function_mode(census):
            yield census
    finally:
        _device.CENSUS = None

