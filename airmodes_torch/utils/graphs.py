"""Compiled steps as captured CUDA graphs: the port's counterpart of
`functools.partial(jax.jit, static_argnames=...)`.

The reference runs each demod step as one compiled XLA program. On a card
the port captures the step's eager function once into a CUDA graph
(`torch.cuda.CUDAGraph`) and replays it per call: the same hand kernels
(B1-B6) and torch ops, launched by one `cudaGraphLaunch` in place of
hundreds of launches from Python, so the tables stay bit for bit those of
the eager step. `torch.compile` is not used: its generated code may
contract products into FMAs and reorder sums, which the port's numeric
rules forbid, and it breaks its graph at every ctypes launch.

    @graphed(static_argnames=("cfg", "tile"), counters=K.LAUNCH_COUNTERS)
    def step(xi, xq, cfg, tile=None, device="cuda"): ...

Semantics of a call:

- The function takes a `device` argument, always static. On the CPU the
  call goes straight to the function (the kernels' plain versions run,
  as on the eager path). On a card:
- **Key.** The static arguments (`static_argnames` plus `device`; None
  wherever it stands) and each other argument's shape and dtype. Those
  arguments are tensors, numpy arrays or numbers (a complex64 array goes
  over as its (..., 2) float32 view, as `dsp.pipeline` lays it out). A
  new key is a new capture, as a new static value is a new trace in JAX.
  An argument's own device only decides how it is copied into the input
  buffer on the card, so a host batch and a batch kept on the card (the
  graph's own buffers, `static_inputs`) replay one graph.
- **Capture**, once per key: the arguments are copied into input buffers
  on the card; the function runs once eagerly on a side stream, which
  loads each kernel library and fills every per-device cache, and is
  synchronised; then it is captured on that stream with
  `capture_error_mode="thread_local"` (the runners' feeder threads may
  allocate page-locked memory meanwhile) and under
  `torch.cuda.set_sync_debug_mode("error")`, so a hidden host
  synchronisation raises. The debug mode is process-wide while the
  capture runs: the runners capture before their consumers read any
  result.
- **Replay**, on the caller's current stream: each argument is copied into
  its input buffer (no copy where the argument is that buffer, see
  `static_inputs`), the graph is replayed, and the outputs are cloned
  stream-ordered, so that no later replay overwrites what a caller holds
  (the runners keep `depth` steps in flight).
- **Counters.** The kernel wrappers count their launches in plain dicts
  (`kernels.preamble.LAUNCHES` and the route dicts), on the host, where
  they launch. A capture launches nothing: its increments are taken back,
  and each replay adds them again.
- **Nesting.** A graphed function called while another one warms up or
  captures runs inline, as a jitted function called inside a jit does.
  Inside `with disable():` every graphed call of the thread runs its
  function eagerly, as under `jax.disable_jit()`: the eager step that a
  measurement or a check holds a graph against.
- **No fallback.** A capture or replay that fails raises; nothing runs the
  eager step on the card in its place.
- **Memory.** Each graph keeps a private memory pool (its intermediates
  and outputs) and its input buffers until it is dropped. Each graphed
  function keeps at most `MAX_GRAPHS` keys, the least recently used
  dropped first; `cache_clear()` drops all of them.

While a profiler records, a capture runs inside the range
"graph capture <name>" (its launches reach no device) and a replay inside
"graph <name>"; the wrappers' own ranges ("B1 detect_cands", ...) open at
capture only, so a trace names a replay's kernels by their symbols.
`DEBUG` = True keeps each graph's node list for
`torch.cuda.CUDAGraph.debug_dump` (`graph_for`).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from .profiling import kernel_range

MAX_GRAPHS = 8       # captured keys kept per graphed function
DEBUG = False        # keep each new graph's nodes for debug_dump

_local = threading.local()   # .inline: > 0 while this thread captures


def _device(bound) -> torch.device:
    """The call's resolved `device` (no card under "cuda" raises), a
    card's with its index ("cuda" and "cuda:0" key one graph)."""
    from ..dsp.pipeline import resolve_device   # it imports this module
    dev = resolve_device(bound.arguments["device"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_card(dev: torch.device) -> bool:
    """Whether a call on `dev` replays a graph (a card) or calls the
    function itself (the CPU)."""
    return dev.type == "cuda"


class CudaGraph:
    """One function captured on a card: its warm-up run and its capture on
    a side stream, its replays on the caller's stream."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        # DEBUG keeps the captured cudaGraph_t beside its executable graph
        # for debug_dump
        self.graph = torch.cuda.CUDAGraph(keep_graph=DEBUG)
        if DEBUG:
            self.graph.enable_debug_mode()
        self.stream = torch.cuda.Stream(dev)
        self.last = None      # the stream of the last replay

    def warm(self, run: Callable[[], Any]) -> None:
        """Run `run` once eagerly on the side stream, after the caller's
        stream (which wrote the inputs), and wait for it. A first call may
        synchronise (filling a per-device cache), whatever debug mode the
        caller set."""
        with _sync_debug(0):
            self.stream.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(self.stream):
                run()
            torch.cuda.synchronize(self.dev)

    def capture(self, run: Callable[[], Any]) -> Any:
        """Capture `run`; returns its outputs (tensors of the graph's pool,
        rewritten by every replay)."""
        with torch.cuda.stream(self.stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                with _sync_debug("error"):
                    out = run()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        if DEBUG:
            self.graph.instantiate()
        return out

    def replay(self) -> None:
        """Replay on the caller's current stream, after whatever the last
        replay's stream had queued by now when that is another stream."""
        cur = torch.cuda.current_stream(self.dev)
        if self.last is not None and self.last != cur:
            cur.wait_stream(self.last)
        self.graph.replay()
        self.last = cur


@contextlib.contextmanager
def _sync_debug(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _inline():
    _local.inline = getattr(_local, "inline", 0) + 1
    try:
        yield
    finally:
        _local.inline -= 1


def disable():
    """Context manager: graphed calls in this thread run their functions
    eagerly, on any device, launch by launch (`jax.disable_jit()`)."""
    return _inline()


def _as_tensor(x) -> torch.Tensor:
    """A dynamic argument as a tensor: numpy arrays and numbers by
    `torch.from_numpy` (complex64 as its (..., 2) float32 view)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool) or not isinstance(
            x, (np.ndarray, np.generic, int, float)):
        raise TypeError(f"a graphed function's dynamic argument must be a "
                        f"tensor, an array or a number, not "
                        f"{type(x).__name__}: make it static")
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if a.dtype == np.complex64:
        a = a.view(np.float32).reshape(*a.shape, 2)
    return torch.from_numpy(a)


def _tree_map(fn, tree):
    """fn over the tensors of a tensor, a tuple (named or not) or a list."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return tree


def _is_buffer(arg: torch.Tensor, buf: torch.Tensor) -> bool:
    return (arg.device == buf.device and arg.data_ptr() == buf.data_ptr()
            and arg.shape == buf.shape and arg.stride() == buf.stride()
            and arg.dtype == buf.dtype)


class _Entry:
    """One key's graph: input buffers by argument name, the capture's
    outputs, the launch counts of one replay."""

    def __init__(self, graph, inputs, outputs, launched):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launched = launched


class Graphed:
    """A graphed function (see the module docstring); made by `graphed`."""

    def __init__(self, fn: Callable, static_argnames: Iterable[str],
                 counters: Tuple[Dict[str, int], ...]):
        self.fn = fn
        self.sig = inspect.signature(fn)
        if "device" not in self.sig.parameters:
            raise TypeError(f"{fn.__name__} takes no `device` argument")
        self.static = frozenset(static_argnames) | {"device"}
        unknown = self.static - set(self.sig.parameters)
        if unknown:
            raise TypeError(f"{fn.__name__} has no argument {sorted(unknown)}")
        self.counters = tuple(counters)
        self.captures = 0     # graphs captured, replays run, since made
        self.replays = 0
        self._cache: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if getattr(_local, "inline", 0):
            return self.fn(*args, **kwargs)
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dev = _device(bound)
        if not _on_card(dev):
            return self.fn(*args, **kwargs)
        key, dyn = self._key(bound, dev)
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                entry = self._capture(key, bound, dyn, dev)
            else:
                self._cache.move_to_end(key)
                self._copy_in(entry, dyn)
            return self._replay(entry)

    def static_inputs(self, *args, **kwargs) -> Tuple[torch.Tensor, ...]:
        """The input buffers of these arguments' graph (captured first if
        new), holding the arguments' values, in the order of the
        function's parameters. Passed back in, they are not copied: a
        caller may keep its input resident in them, or write its
        host-to-card copies straight into them. On the CPU, the
        arguments as tensors."""
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dev = _device(bound)
        key, dyn = self._key(bound, dev)
        if not _on_card(dev):
            return tuple(dyn.values())
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                entry = self._capture(key, bound, dyn, dev)
            else:
                self._copy_in(entry, dyn)
            return tuple(entry.inputs.values())

    def graph_for(self, *args, **kwargs):
        """The captured graph of these arguments (captured first if new):
        a `torch.cuda.CUDAGraph`, whose `debug_dump` lists its nodes when
        `DEBUG` was set before the capture."""
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dev = _device(bound)
        if not _on_card(dev):
            raise ValueError(f"no graph on {dev}: the CPU runs the function")
        key, dyn = self._key(bound, dev)
        with self._lock:
            entry = self._cache.get(key)
            if entry is None:
                entry = self._capture(key, bound, dyn, dev)
            return entry.graph.graph

    def cache_clear(self) -> None:
        """Drop every captured graph, with its memory pool and buffers."""
        with self._lock:
            self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)

    def __repr__(self) -> str:
        return f"<graphed {self.__module__}.{self.__name__}>"

    def _key(self, bound, dev):
        """(key, {name: tensor} of the dynamic arguments)."""
        key, dyn = [("device", dev)], {}
        for name, v in bound.arguments.items():
            if name == "device":
                continue
            if name in self.static or v is None:
                key.append((name, v))
            else:
                t = _as_tensor(v)
                dyn[name] = t
                key.append((name, tuple(t.shape), t.dtype))
        return tuple(key), dyn

    def _capture(self, key, bound, dyn, dev) -> _Entry:
        inputs = {n: torch.empty(t.shape, dtype=t.dtype, device=dev)
                  for n, t in dyn.items()}
        for n, t in dyn.items():
            inputs[n].copy_(t, non_blocking=True)
        args = dict(bound.arguments, **inputs)
        graph = CudaGraph(dev)
        with _inline():
            graph.warm(lambda: self.fn(**args))
            before = [dict(d) for d in self.counters]
            with kernel_range(f"graph capture {self.__name__}"):
                outputs = graph.capture(lambda: self.fn(**args))
        # the capture launched nothing: take back what it counted, and let
        # each replay add it
        launched = []
        for d, b in zip(self.counters, before):
            one = {k: n - b.get(k, 0) for k, n in d.items()
                   if n != b.get(k, 0)}
            for k, n in one.items():
                d[k] -= n
            launched.append(one)
        entry = _Entry(graph, inputs, outputs, launched)
        self.captures += 1
        self._cache[key] = entry
        while len(self._cache) > MAX_GRAPHS:
            self._cache.popitem(last=False)
        return entry

    @staticmethod
    def _copy_in(entry: _Entry, dyn) -> None:
        for n, t in dyn.items():
            buf = entry.inputs[n]
            if not _is_buffer(t, buf):
                buf.copy_(t, non_blocking=True)

    def _replay(self, entry: _Entry):
        with kernel_range(f"graph {self.__name__}"):
            entry.graph.replay()
        out = _tree_map(torch.clone, entry.outputs)
        for d, one in zip(self.counters, entry.launched):
            for k, n in one.items():
                d[k] += n
        self.replays += 1
        return out


def graphed(static_argnames: Iterable[str] = (),
            counters: Iterable[Dict[str, int]] = ()) -> Callable:
    """Decorator: the function as a `Graphed` (module docstring), with
    `static_argnames` (and `device`) static and `counters` the launch
    counters its kernel wrappers bump."""
    def wrap(fn):
        return Graphed(fn, static_argnames, tuple(counters))
    return wrap


__all__ = ["CudaGraph", "DEBUG", "Graphed", "MAX_GRAPHS", "disable",
           "graphed"]
