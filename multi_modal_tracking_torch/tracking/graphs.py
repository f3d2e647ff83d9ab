"""CUDA graphs of the trackers' per-frame step and of the trainer's step:
the port's counterparts of the JAX tracker's jitted step, one compiled
program per frame shape, and of the JAX trainer's jitted step, one per CE
keep bucket (train/train_step.py).

A tracker's step reads and writes only static tensors: its inputs (the
two uint8 frames, and for the lockstep tracker the `live` mask), its state
(the box, the templates, the template cache) and its outputs (the lockstep
tracker's boxes of the frame). `StepGraphs` captures the step once per key
(frame shape, and whether the template is updated: the host's frame
counter picks the key, as `lax.cond` picks the branch inside the JAX step)
and replays it after that; the step then costs the host one graph launch
instead of about a thousand kernel launches.

Capture (`StepGraphs.run`): the first step of a key runs eager on the
runner's side stream, as the real step: it builds the kernel libraries and
fills every first-use cache (the fusion's `_pos_and_ref`, the crop's
constants, cuBLAS's workspaces). The step is then captured into a
`torch.cuda.CUDAGraph` for the next call of that key: a capture records
the kernels and runs none, so no step runs twice and no state needs
putting back. All the graphs of a runner come from its one memory pool
(they never run concurrently, and every tensor a graph leaves behind lives
in a static buffer outside the pool). A capture that fails raises with the
operation at fault; nothing falls back to running eager. Before it
raises, the runner undoes what the failed capture left behind in the
process: torch.cuda.graph does not restore the thread's current stream,
and the caching allocator would go on treating the capture as under way
(after which `empty_cache` releases nothing, an allocation that needs
memory cached for another stream fails, and a block freed after
`record_stream` is never reused), and the pool would keep the failed
capture's reference.

The bf16 attention kernels encode their TMA tensor maps on the host at
each call (csrc/wgmma_bf16.cuh), with the addresses of q, k and v. A
captured launch keeps the maps it was given, so a replay reads the
addresses of the capture. That is right only because those addresses never
change: every tensor of a captured step is a static buffer or a block of
the graph's pool, at the same address at every replay.

The trainer's dropout and drop-path masks come from the Trainer's own CUDA
generator, registered with each of its graphs (`register_generator_state`):
a replay draws from the generator's offset at that replay and advances it
by what the step draws, as the eager step does.

Launch counts: a wrapper counts its kernel when its Python code runs
(`mixed_attention*.launches`, `ms_deform_attn*.launches`,
`launches_by_kernel` and `adamw_fused.launches`), which a replay does not.
The runner records each graph's counts at capture and adds them at each
replay, so a graphed step counts what an eager one does; a key's eager
first step counts as the step it is, and the capture launches nothing. A
wrapper called while its stream captures counts in the capture's record
(`ops/_build.py record_capture`), not in the process's counts: the
backward's kernels are launched from the autograd engine's own thread,
and a worker that launches eagerly while another captures
(eval/running.py run_dataset(threads=...)) adds nothing to that graph.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _counters():
    from multi_modal_tracking_torch.ops.adamw import adamw_fused
    from multi_modal_tracking_torch.ops.attention import (mixed_attention,
                                                          mixed_attention_bf16,
                                                          mixed_attention_bwd,
                                                          mixed_attention_bwd_bf16)
    from multi_modal_tracking_torch.ops.msda import (ms_deform_attn, ms_deform_attn_bf16,
                                                     ms_deform_attn_bwd,
                                                     ms_deform_attn_bwd_bf16)
    return (mixed_attention, mixed_attention_bf16, mixed_attention_bwd,
            mixed_attention_bwd_bf16, ms_deform_attn, ms_deform_attn_bf16,
            ms_deform_attn_bwd, ms_deform_attn_bwd_bf16, adamw_fused)


def read_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, `launches_by_kernel` entries as
    "<wrapper>/<kernel>"."""
    out = {}
    for fn in _counters():
        out[fn.__name__] = fn.launches
        for k, v in getattr(fn, "launches_by_kernel", {}).items():
            out[f"{fn.__name__}/{k}"] = v
    return out


def add_counts(delta: Dict[str, int]) -> None:
    """Add launch counts in read_counts' keys (a replay's)."""
    from multi_modal_tracking_torch.ops import _build
    _build.add_launches({fn.__name__: fn for fn in _counters()}, delta)


#: one capture at a time in the process: trackers on several threads
#: (eval/running.py run_dataset(threads=...)) may capture at once, and a
#: capture begins with a device-wide synchronise
_CAPTURE_LOCK = threading.Lock()


class OpLog(TorchDispatchMode):
    """Records the name of every aten operation dispatched under it
    (e.g. "aten.add.Tensor"), in order."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a structure of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def clone_tree(tree):
    """A structure of dicts, lists and tuples with every tensor cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(x) for x in tree)
    return tree.clone()


def copy_tree(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place in
    `dst` (a structure of the same shape)."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        d.copy_(s)


def bind_state(slots: dict, values: dict) -> dict:
    """The state buffers for `values` (name -> tensor structure): those in
    `slots` of the same shapes and dtypes, refilled with `values`, or new
    clones of `values` kept there. A graph holds its buffers' addresses, so
    a tracker allocates them once per state shape and writes into them."""
    key = tuple((name, tuple(t.shape), t.dtype) for name in sorted(values)
                for t in leaves(values[name]))
    bufs = slots.get(key)
    if bufs is None:
        bufs = slots[key] = {name: clone_tree(v) for name, v in values.items()}
    else:
        for name, v in values.items():
            copy_tree(bufs[name], v)
    return bufs


class StaticInputs:
    """A step's static input tensors of one shape. `load_device` fills them
    from device tensors (a copy on the device); `load_host` from host
    arrays, on CUDA through one of two pinned staging buffers and a
    non-blocking copy. Before a staging buffer is written again, the host
    waits for the event recorded after its last copy, so a frame is never
    overwritten before its copy has run, and the host runs up to two
    frames ahead of the card."""

    def __init__(self, shapes: Sequence[tuple], dtypes: Sequence[torch.dtype],
                 device: torch.device):
        self.key = tuple((tuple(s), d) for s, d in zip(shapes, dtypes))
        self.device = device
        self.tensors = [torch.empty(s, dtype=d, device=device) for s, d in self.key]
        self._stage = None
        self._events = [None, None]
        self._next = 0

    def load_device(self, srcs: Sequence[torch.Tensor]) -> None:
        for t, s in zip(self.tensors, srcs, strict=True):
            t.copy_(s)

    def load_host(self, arrays: Sequence[np.ndarray]) -> None:
        if self.device.type != "cuda":
            self.load_device([torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
            return
        if self._stage is None:
            self._stage = [[torch.empty(s, dtype=d, pin_memory=True) for s, d in self.key]
                           for _ in range(2)]
        k, self._next = self._next, 1 - self._next
        if self._events[k] is not None:
            self._events[k].synchronize()
        for buf, t, a in zip(self._stage[k], self.tensors, arrays, strict=True):
            buf.numpy()[...] = a
            t.copy_(buf, non_blocking=True)
        self._events[k] = torch.cuda.Event()
        self._events[k].record()


class StepGraphs:
    """The CUDA graphs of one tracker's or trainer's step, one per key, all
    from one memory pool (module docstring). `capture_ms` (per key; the
    capture alone, without the key's eager first step) and `pool_bytes()`
    are kept for the reports. `what` names the step in a capture's error."""

    def __init__(self, device: torch.device, what: str = "tracking step"):
        self.device = device
        self.what = what
        self.pool = None
        self._side = None           # the stream of the keys' eager first steps
        self._graphs: Dict[tuple, tuple] = {}
        self.capture_ms: Dict[tuple, float] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def pool_bytes(self) -> int:
        """Device memory held by the graphs' pool (its segments)."""
        if self.pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self.pool))

    def run(self, key: tuple, step, generators=tuple) -> None:
        """Run `step` (a function of static tensors only) once for `key`: a
        replay of its graph if it has one; else `step` itself, eager on the
        side stream (the real step, which also fills the first-use caches),
        then its capture for the next call. `generators()`: the CUDA
        generators `step` draws from, each registered with the graph
        (called only to capture)."""
        entry = self._graphs.get(key)
        if entry is not None:
            graph, counts = entry
            graph.replay()
            add_counts(counts)
            return
        with _CAPTURE_LOCK:
            main = torch.cuda.current_stream(self.device)
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                step()
            main.wait_stream(self._side)
            self._graphs[key] = self._capture(key, step, generators())

    def _capture(self, key, step, generators):
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        from multi_modal_tracking_torch.ops._build import record_capture
        log = OpLog()
        stream = torch.cuda.current_stream(self.device)
        try:
            with record_capture() as counts, \
                    torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                with log:
                    step()
        except Exception as e:
            undo_failed_capture(self.device, self.pool, stream)
            if not self._graphs:        # the pool is let go: the next capture starts a new one
                self.pool = None
            at = log.ops[-1] if log.ops else "its first operation"
            cause = f"; first error: {e.__context__}" if e.__context__ is not None else ""
            raise RuntimeError(f"capturing the {self.what} {key} failed at {at} (operation "
                               f"{len(log.ops)} of the step): {e}{cause}") from e
        torch.cuda.synchronize(self.device)
        self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
        return graph, counts


def undo_failed_capture(device: torch.device, pool, stream: torch.cuda.Stream) -> None:
    """Undo what a `torch.cuda.graph` capture into `pool` that raised leaves
    behind (module docstring; torch 2.11 does not clean up): the
    capture stream as the thread's current stream (`stream` was current
    before), the caching allocator's capture into the pool still open, and
    the capture's reference to the pool, which the unfinished graph never
    drops; a pool that no graph holds any more is freed at the next
    `empty_cache`."""
    torch.cuda.set_stream(stream)
    index = device.index if device.index is not None else torch.cuda.current_device()
    torch._C._cuda_endAllocateToPool(index, pool)
    torch._C._cuda_releasePool(index, pool)
