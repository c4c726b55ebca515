"""The decode step built once per program — the port's counterpart of the
reference's ``jax.jit`` of the step (``repro/serving/engine.py``
``_jit_counted``), as CUDA graphs.

On the card a program's first step runs eagerly: it is a real step, and it
warms what the step reads from the host once (the kernels' libraries and
shared-memory attributes, the TMA encoder's ``dlopen``, the RoPE
frequencies, a tree template's device tables).  The second step is
captured into a ``torch.cuda.CUDAGraph`` and replayed, and every later step
replays it: one launch from the host where the eager step makes ~400 kernel
wrapper calls and a few thousand torch ops.

A graph bakes in more than XLA keys a program on.  Besides the shapes and
the step's constants (temperature, drafter and template, verifier, KV
dtype and layout: one step function each), it holds every address it reads
and writes.  So a program is keyed by

* the step function,
* the identity of the prepared params: the graph reads the weights where
  they were at capture, so a re-prepared tree is a new program (replace the
  params object, never a tensor inside it),
* the state's buffers (address, shape and dtype of every state tensor, in
  order) and its generators (one per row; a graph draws from the
  generators registered at its capture).

The decode step writes its results into the state's own tensors
(``core/spec_engine.py``), admission, preemption and resume write rows in
place and reseed a row's generator in place (``core/prng.reseed``), so one
state keeps one key from its first step to its last.  ``step_traces``
counts the programs built, as the reference counts traces: on the card
each is followed by a capture at its next step; on the CPU, or with
``graphs=False`` (the counterpart of ``jax.disable_jit()``, for checks),
the step runs eagerly every time and the same keys are counted.  There is
no silent eager path on the card: a capture or replay that fails raises.

A serving front-end (``serving/server.py``) keeps up to eight lanes, each
with its own state and so its own program, plus each lane's bf16 fallback
twin after a non-finite-logits trip: :data:`MAX_PROGRAMS` holds them all,
and a program whose params object died (a poisoned view of the fault
seams, a lane's params before a repair) is dropped before any live one is
evicted.  A torn-down lane's programs go with :meth:`StepPrograms.forget`.
The serving loop captures on its own thread while callers submit and
consume from theirs, so a capture runs in ``"thread_local"`` error mode:
what another thread does on the card cannot break it (the callers' side of
the server is numpy and makes no card call).

Kernel launches are counted in the wrappers (``kernels/ops.LAUNCHES``),
which a replay does not run: a capture records what the wrappers counted
(``ops.launches_apart``) and each replay adds it once.  Host work of the
scheduler tick (block top-up, copy-on-write, admission) stays outside the
captured region and writes the block table and pools in place.
"""
from __future__ import annotations

import collections
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops

# an engine's live programs: a server's 8 lanes × (step, bf16 fallback twin),
# plus a lane's params before a repair and after it
MAX_PROGRAMS = 20


def _buffers(tree, out: list) -> list:
    """The tensors of a nested dict/list, in order (generators skipped)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _buffers(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _buffers(v, out)
    return out


@dataclass
class Program:
    """One key's step program: the params it was built for (weakly), what
    its graph draws from (kept alive, so their identities stay unique), and,
    once captured, the graph and the kernel launches of one replay."""

    params: weakref.ref
    holds: tuple
    graph: Optional[object] = None
    launches: collections.Counter = field(default_factory=collections.Counter)

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launches(self.launches)


class StepPrograms:
    """One engine's step programs: the bounded cache, one memory pool shared
    by its graphs, and the counters ``step_traces`` (programs built),
    ``captures`` and ``capture_s`` (host seconds spent capturing)."""

    def __init__(self, graphs: bool = True):
        self.graphs = graphs
        self.step_traces = 0
        self.captures = 0
        self.capture_s = 0.0
        self._programs: collections.OrderedDict = collections.OrderedDict()
        self._pool = None

    def counted(self, step_fn: Callable) -> Callable:
        """``step_fn(params, state) -> state`` run through the programs."""
        def step(params, state):
            return self.run(step_fn, params, state)
        return step

    @staticmethod
    def _on_card(state) -> bool:
        return state["tokens"].is_cuda

    @staticmethod
    def _key(step_fn, params, state) -> tuple:
        return (id(step_fn), id(params),
                tuple((t.data_ptr(), t.shape, t.dtype) for t in _buffers(
                    [state[k] for k in state if k != "generators"], [])),
                tuple(map(id, state["generators"])))

    def run(self, step_fn, params, state) -> dict:
        key = self._key(step_fn, params, state)
        prog = self._programs.get(key)
        if prog is None or prog.params() is not params:
            return self._build(key, step_fn, params, state)
        self._programs.move_to_end(key)
        if prog.graph is None:
            if not (self.graphs and self._on_card(state)):
                step_fn(params, state)
                return state
            self._capture(prog, step_fn, params, state)
        prog.replay()
        return state

    def _build(self, key, step_fn, params, state) -> dict:
        self.step_traces += 1
        step_fn(params, state)          # the program's first step runs eagerly
        if self._key(step_fn, params, state) != key:
            raise RuntimeError("the decode step replaced a state tensor or generator; "
                               "it must write the state in place")
        for k in [k for k, p in self._programs.items() if p.params() is None]:
            del self._programs[k]       # their params died: never run again
        if len(self._programs) >= MAX_PROGRAMS:
            self._programs.popitem(last=False)
        self._programs[key] = Program(weakref.ref(params),
                                      (step_fn, tuple(state["generators"])))
        return state

    def forget(self, state) -> None:
        """Drop every program built on ``state`` (a torn-down lane's)."""
        gens = tuple(map(id, state["generators"]))
        for k in [k for k in self._programs if k[-1] == gens]:
            del self._programs[k]

    def _capture(self, prog: Program, step_fn, params, state) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in state["generators"]:
            graph.register_generator_state(g)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        with ops.launches_apart() as launches:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                step_fn(params, state)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        prog.graph, prog.launches = graph, launches
