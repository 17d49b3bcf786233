"""What a step issues, read as it runs: collective bytes, the aten-op
histogram and the peak of live memory.  The counterpart of
``repro/launch/hlo_analysis.py``, under another name because the port
has no HLO to parse: PyTorch runs a step op by op, so a
``TorchDispatchMode`` sees every op, the ``_c10d_functional``
collectives that DTensor redistributions issue among them, with their
tensors' sizes (it lets a DTensor op desugar first, so it counts the
local ops and collectives each rank runs, and it skips the global-shape
fake tensors DTensor's sharding propagation makes for itself, which
hold no memory in a real run).  Under a ``FakeTensorMode`` (the dry-run) nothing is
allocated and the fake process group moves nothing; the sizes are the
ones a real run on that mesh would have.

``collective_report`` keeps the reference's keys and convention: the
bytes of each collective's result on one device (the gathered tensor of
an all-gather, the scattered shard of a reduce-scatter), summed by kind,
plus ``total``, so ``analytic.roofline_terms`` takes it unchanged.  A
loop runs its collectives each time round, so no trip counts are needed.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op -> the reference's kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class StepRecorder(TorchDispatchMode):
    """Records, while active: collective result bytes by kind, the count
    of every op, and the bytes of storages made by ops that are still
    alive (``live_bytes``) and their peak (``peak_bytes``).  Storages
    made before it started are not counted; pass the step's arguments to
    ``own`` first, so their views are not counted either."""

    def __init__(self):
        super().__init__()
        self.coll: Dict[str, int] = defaultdict(int)
        self.ops: Dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.last_op: Optional[str] = None    # the op running, or last run
        self._seen = WeakIdKeyDictionary()
        self._in_propagation = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        orig = self._orig_prop = \
            ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *args, **kwargs):
            self._in_propagation += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._in_propagation -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = \
            self._orig_prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar the op into local ops and collectives,
            # which come back here (modes run before subclasses)
            return NotImplemented
        if self._in_propagation:            # DTensor's own shape algebra
            return func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.__name__.split(".")[0]
        self.last_op = f"{ns}.{name}"
        out = func(*args, **(kwargs or {}))
        self.ops[self.last_op] += 1
        if ns == "_c10d_functional" and name != "wait_tensor":
            self.coll[_KIND.get(name, name)] += _nbytes(_tensors(out))
        for t in _tensors(out):
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, n)
        return out

    def own(self, tree) -> None:
        """Mark the storages of a tree's tensors (a DTensor's shard) as
        made before: views of them cost nothing."""
        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            self._seen[t.untyped_storage()] = 0

    def collective_report(self) -> Dict[str, int]:
        """Per-device collective bytes by kind, plus ``total``."""
        out = {k: self.coll.get(k, 0) for k in COLLECTIVES}
        out.update({k: v for k, v in self.coll.items() if k not in out})
        out["total"] = sum(out.values())
        return out

    def op_histogram(self) -> Dict[str, int]:
        """Op counts, most frequent first (the perf loop's smell test:
        copies and reshapes near collectives)."""
        return dict(sorted(self.ops.items(), key=lambda kv: -kv[1]))


def collective_report(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once; its per-device collective bytes
    by kind, plus ``total``."""
    with StepRecorder() as rec:
        fn(*args, **kwargs)
    return rec.collective_report()


def op_histogram(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once; the count of each op it ran."""
    with StepRecorder() as rec:
        fn(*args, **kwargs)
    return rec.op_histogram()
