"""Per-device cost of one step from its op stream: the counterpart of the
JAX package's ``src/repro/launch/hlo_analysis.py``, which parses compiled
(post-SPMD) HLO text.

The port compiles nothing, so it has no HLO. What stands in for it is the
stream of ops one rank runs when the step is run once, eagerly, under a
dispatch mode (``OpCounter``): on a mesh the DTensor ops are seen as the
local ops and collectives they become, which is what the reference's
post-SPMD HLO holds. It fills the reference's ``HLOAnalysis`` fields, the
ones ``dryrun`` reads:

  * **flops**: matmul and convolution FLOPs of the local ops (``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, convolutions, by
    ``torch.utils.flop_counter``'s formulas), as the reference counts
    ``dot``/``convolution``. Per device: a ``FlopCounterMode`` around
    DTensor code counts the *global* ops instead.
  * **hbm_bytes**: the operand and result bytes of every local op that is
    not a view. In eager mode every op is a kernel boundary, the counterpart
    of the reference's fusion boundaries (so this is the traffic of the
    unfused op stream, an upper bound on a fused one).
  * **collective_bytes** / **collectives**: the operand bytes (and count) of
    every c10d functional collective, under the reference's ``COLLECTIVES``
    names.
  * **unknown_trip_whiles**: always 0. The reference counts while loops
    whose trip count it cannot read; an eager loop runs every iteration, so
    each one is seen.

``OpCounter`` also keeps the live bytes of the storages the ops create
(plus the ones ``track`` registers: the step's arguments) and their peak,
the dry run's per-device memory, and on request (``at_peak``) what was live
at that peak. The HLO text parser is not copied: nothing in the port would
feed it.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

#: c10d functional op -> the reference's collective name
_C10D = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "broadcast": "collective-broadcast"}

#: ops that move no HBM bytes themselves (besides views); ``device`` is the
#: query ``tensor.device`` dispatches (``prim.device``) under a mode, which
#: reads no element
_FREE = {"detach", "empty", "empty_like", "empty_strided", "alias",
         "_local_scalar_dense", "wait_tensor", "lift_fresh", "set_",
         "resize_", "device"}

_FLOP_OPS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
             "convolution_backward")


@dataclasses.dataclass
class HLOAnalysis:
    flops: float                       #: per-device
    hbm_bytes: float                   #: op-boundary traffic, per-device
    collective_bytes: float            #: operand bytes, per-device
    collectives: Dict[str, Dict[str, float]]   #: per kind: count / bytes
    unknown_trip_whiles: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


class OpCounter(TorchDispatchMode):
    """Counts the local ops run under it (see the module docstring). A
    DTensor op is handed on (``NotImplemented``) so that its local ops and
    collectives come back through here. DTensor works out an op's output
    by running it on fake tensors of the global shapes
    (``ShardingPropagator._propagate_tensor_meta*``, wrapped while the
    counter is entered); the ops of that run are not counted."""

    def __init__(self, at_peak: bool = False):
        super().__init__()
        self._in_propagation = 0
        self._patched = []
        from torch.utils.flop_counter import flop_registry
        self._flop = {k: v for k, v in flop_registry.items()
                      if k.__name__ in _FLOP_OPS}
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._storages = set()
        # with ``at_peak``: each live storage's (bytes, shape, dtype, the op
        # that made it), and their copy where the live bytes last rose to
        # the peak (taken at the first free after it: once a local maximum)
        self._desc = {} if at_peak else None
        self._rising = False
        self._at_peak = []

    # -- memory ---------------------------------------------------------------
    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` (a tree; a DTensor's local one)
        as live, as the step's arguments are."""
        from torch.distributed.tensor import DTensor
        # ``to_local``'s view is no op of the step: not counted
        self._in_propagation += 1
        try:
            local = [t.to_local() if isinstance(t, DTensor) else t
                     for t in _tensors(tensors)]
        finally:
            self._in_propagation -= 1
        for t in local:
            self._add(t, "argument")

    def _add(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages.add(key)
        self.live += n
        if self._desc is not None:
            self._desc[key] = (n, tuple(t.shape), str(t.dtype), op)
            if self.live > self.peak:
                self._rising = True
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if self._rising:
            self._snapshot()
        self._storages.discard(key)
        self.live -= n
        if self._desc is not None:
            self._desc.pop(key, None)

    def _snapshot(self) -> None:
        self._at_peak = list(self._desc.values())
        self._rising = False

    def at_peak(self, n: int = 20) -> Dict:
        """What was live at the peak: the ``n`` largest storages as
        {bytes, shape, dtype, op}, largest first, and the bytes of the
        rest (``OpCounter(at_peak=True)`` only)."""
        if self._desc is None:
            raise ValueError("OpCounter(at_peak=True) keeps what is live")
        if self._rising:
            self._snapshot()
        live = sorted(self._at_peak, key=lambda d: -d[0])
        return {"largest": [{"bytes": b, "shape": list(s), "dtype": dt,
                             "op": op} for b, s, dt, op in live[:n]],
                "rest_bytes": sum(d[0] for d in live[n:]),
                "count": len(live)}

    # -- ops ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._in_propagation:
            return out
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in _C10D:
            kind = _C10D[name]
            b = float(sum(_nbytes(t) for t in _tensors(args[0])))
            slot = self.collectives.setdefault(kind, {"count": 0.0,
                                                      "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += b
        if func.overloadpacket in self._flop:
            self.flops += float(self._flop[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if not func.is_view and name not in _FREE:
            self.hbm_bytes += float(sum(_nbytes(t) for t in _tensors(args))
                                    + sum(_nbytes(t) for t in _tensors(out)))
        for t in _tensors(out):
            self._add(t, name)
        return out

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                self._in_propagation += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._in_propagation -= 1

            setattr(ShardingPropagator, name, wrapped)
            self._patched.append((ShardingPropagator, name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        for cls, name, orig in self._patched:
            setattr(cls, name, orig)
        self._patched = []
        return super().__exit__(*exc)

    def analysis(self) -> HLOAnalysis:
        return HLOAnalysis(
            flops=self.flops, hbm_bytes=self.hbm_bytes,
            collective_bytes=sum(c["bytes"] for c in
                                 self.collectives.values()),
            collectives=self.collectives)


def analyze(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its ``HLOAnalysis``): ``fn`` run once
    under an ``OpCounter``."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.analysis()


__all__ = ["COLLECTIVES", "HLOAnalysis", "OpCounter", "analyze"]
