"""Programs: a function of device tensors run as one captured CUDA graph
for each shape it is called with, the port's counterpart of the JAX
package's ``jax.jit`` (``block_jax._plan_block_core``, ``split_jax``'s
batched splitter, the match stage's ``_salcp_batch``, walk and
``_assemble_stacked``).

``run(fn, *inputs, **statics)`` calls ``fn(*inputs, **statics)``. On a
CUDA device the call is keyed on ``fn`` itself, the shape and type of
every input (or its absence, for a ``None``) and the static keywords, and
each device keeps its own programs:

- The first call of a key runs ``fn`` eagerly: a graph pays off only when
  its shape comes again, and a shape that a process meets once (a file
  through the CLI) costs what the eager path costs.
- The second call copies the inputs into static buffers, captures ``fn``
  on them into a graph, in the device's one memory pool, and replays it.
- A later call copies its inputs into the static buffers (device copies)
  and replays the graph: no Python runs between the inputs going in and
  the outputs coming out, and nothing waits for the host. The outputs are
  copied out at once, before anything else can replay: the graph's own
  output tensors are rewritten by its next replay, and another graph of
  the pool may use their memory for its intermediates.

A device keeps at most ``MAX_PROGRAMS`` graphs and remembers at most
``MAX_PROGRAMS`` keys seen once; past that the least recently used goes,
so a process that meets many shapes holds a bounded set.

A capture cannot hold a host sync, so the captured functions take their
constant tables from ``tables.device_tables`` and copy nothing from the
host. Kernel launches a capture makes do not run then: they are counted
on the graph (``ops.capturing_launches``) and added to the launch counts
on each replay, so the counts keep meaning launches the device executed.
One lock a device covers the calls, captures and replays, so host threads
that share a card (``compress_device(devices=[...])``) take turns. A CPU
tensor calls ``fn`` directly. A capture or a replay that fails raises;
nothing falls back to eager calls on the card.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import torch

from .. import profiling
from . import add_launches, capturing_launches


MAX_PROGRAMS = 32  # graphs a device keeps, and keys seen once it remembers


def program_key(fn, inputs, statics: dict) -> tuple:
    """What a program is cached under on its device."""
    shapes = tuple(None if x is None else (tuple(x.shape), str(x.dtype)) for x in inputs)
    return (fn, shapes, tuple(sorted(statics.items())))


def key_text(key) -> str:
    """A program key as text: the function's name, its inputs' shapes and
    types, its static keywords."""
    fn, shapes, statics = key
    args = ["None" if s is None else f"{list(s[0])} {s[1].removeprefix('torch.')}"
            for s in shapes] + [f"{k}={v}" for k, v in statics]
    return f"{fn.__qualname__}({', '.join(args)})"


def _leaves(out) -> list:
    return list(out.values()) if isinstance(out, dict) else list(out)


def _like(out, leaves):
    return dict(zip(out, leaves)) if isinstance(out, dict) else type(out)(leaves)


class Program:
    """One key's graph: its static inputs and outputs, and the kernel
    launches one replay makes."""

    __slots__ = ("key", "fn", "statics", "inputs", "graph", "outputs", "launches", "capture_ms")

    def __init__(self, key, fn, statics, inputs):
        self.key, self.fn, self.statics, self.inputs = key, fn, statics, inputs
        self.graph = self.outputs = None
        self.launches = {}
        self.capture_ms = 0.0


class CudaGraphs:
    """Capture and replay on one CUDA device, every graph in one memory
    pool. Replays of one device are serialized (the device's lock) and
    each graph's outputs are copied out right after its replay, so the
    graphs may share the pool. The key's first call, eager, has already
    made the lazy set-ups (the kernels' library, per-device attributes)
    that a capture must not make."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def capture(self, fn, inputs, statics):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn(*inputs, **statics)
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()

    def current(self):
        """The device made current for a call (a replay launches on the
        current device's current stream)."""
        return torch.cuda.device(self.device)


class DevicePrograms:
    """The programs of one device, behind one lock. ``graphs`` captures
    and replays (``CudaGraphs``, or a stand-in in the tests)."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.lock = threading.Lock()
        self.programs: OrderedDict = OrderedDict()  # key -> Program, least recent first
        self.seen: OrderedDict = OrderedDict()  # keys called once, least recent first

    def run(self, fn, inputs, statics):
        key = program_key(fn, inputs, statics)
        with self.lock, self.graphs.current():
            prog = self.programs.get(key)
            if prog is not None:
                self.programs.move_to_end(key)
                for buf, x in zip(prog.inputs, inputs):
                    if x is not None:
                        buf.copy_(x)
                profiling.count("program.replay")
            elif key in self.seen:
                del self.seen[key]
                prog = self._capture(key, fn, inputs, statics)
            else:
                _remember(self.seen, key, None)
                profiling.count("program.eager")
                return fn(*inputs, **statics)
            self.graphs.replay(prog.graph)
            add_launches(prog.launches)
            return _like(prog.outputs, [t.clone() for t in _leaves(prog.outputs)])

    def _capture(self, key, fn, inputs, statics) -> Program:
        t0 = time.perf_counter()
        prog = Program(key, fn, statics,
                       [None if x is None else x.clone(memory_format=torch.contiguous_format)
                        for x in inputs])
        with capturing_launches() as launches:
            prog.graph, prog.outputs = self.graphs.capture(fn, prog.inputs, statics)
        prog.launches = {k: n for k, n in launches.items() if n}
        prog.capture_ms = (time.perf_counter() - t0) * 1e3
        profiling.count("program.capture")
        profiling.count("program.capture_s", prog.capture_ms / 1e3)
        _remember(self.programs, key, prog)
        return prog


def _remember(table: OrderedDict, key, value) -> None:
    """``table[key] = value`` as its most recent entry, the least recent
    dropped past ``MAX_PROGRAMS`` (a dropped graph counts as an eviction)."""
    table[key] = value
    table.move_to_end(key)
    while len(table) > MAX_PROGRAMS:
        if table.popitem(last=False)[1] is not None:
            profiling.count("program.evict")


_devices: dict = {}  # CUDA device index -> DevicePrograms
_devices_lock = threading.Lock()


def device_programs(device) -> DevicePrograms:
    """The programs of a CUDA device, made on first use."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with _devices_lock:
        progs = _devices.get(index)
        if progs is None:
            progs = _devices[index] = DevicePrograms(CudaGraphs(torch.device("cuda", index)))
    return progs


def run(fn, *inputs, **statics):
    """``fn(*inputs, **statics)``, replayed as a graph on a CUDA device
    (captured on the key's first call); a direct call on the CPU. ``fn``
    returns a tuple or a dict of tensors."""
    dev = next(x.device for x in inputs if x is not None)
    if dev.type != "cuda":
        return fn(*inputs, **statics)
    return device_programs(dev).run(fn, inputs, statics)


def captured(device="cuda") -> list:
    """One dict a program of ``device``: its key, the key as text, the
    kernel launches of a replay and the capture's host ms."""
    progs = device_programs(device)
    with progs.lock:
        return [{"key": p.key, "text": key_text(p.key), "launches": dict(p.launches),
                 "capture_ms": p.capture_ms} for p in progs.programs.values()]


def pool_bytes(device="cuda") -> int:
    """Bytes the device's graph pool holds (its segments, from the
    allocator's snapshot)."""
    progs = device_programs(device)
    pool = tuple(progs.graphs.pool)
    index = progs.graphs.device.index
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == pool)


def replay_against_eager(device="cuda", reps: int = 3, fn=None) -> list:
    """Replay every program of ``device`` (those of the function ``fn``
    alone, if given) on the static inputs its last call left, with
    ``torch.cuda.set_sync_debug_mode("error")`` around the replay (a sync
    there raises), and call its function eagerly on the same inputs. -> one
    dict a program: key, max abs err over every output (exact equality is
    0), replay ms and eager ms (CUDA events, mean of ``reps``)."""
    progs = device_programs(device)
    rows = []
    with progs.lock, progs.graphs.current():
        for p in progs.programs.values():
            if fn is not None and p.fn is not fn:
                continue
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                progs.graphs.replay(p.graph)
                got = [t.clone() for t in _leaves(p.outputs)]
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            want = _leaves(p.fn(*p.inputs, **p.statics))
            err = 0
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise RuntimeError(f"program {key_text(p.key)}: replay and eager outputs differ in "
                                       f"shape or type")
                if g.numel():
                    err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            rows.append({"key": p.key, "text": key_text(p.key), "launches": dict(p.launches),
                         "max_abs_err": err,
                         "replay_ms": _event_ms(lambda p=p: progs.graphs.replay(p.graph), reps),
                         "eager_ms": _event_ms(lambda p=p: p.fn(*p.inputs, **p.statics), reps),
                         "capture_ms": p.capture_ms})
    return rows


def _event_ms(call, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
