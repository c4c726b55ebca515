"""The system under test: ``repro_torch``'s ``ServingLoop`` over a
``SpecEngine``, built from a configuration file and the benchmark's raw
weights, and the records the readers take from its hooks.

This is the one module of the benchmark that imports the program.  What it
takes from it: the model, engine and serving loop, the ``ServerMetrics``
hooks (admission, streamed tokens, finishes, each decode step's accepted
counts) and the ``Tracer`` spans.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from benchkit.weights import DTYPES


def build_kernels() -> None:
    """Every kernel source at once, into the checkout's content-hashed
    build directory (``src/repro_torch/csrc/_build``): only a checkout's
    first run compiles."""
    from repro_torch.kernels import ops

    ops.build()


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from a configuration file's ``model``."""
    from repro_torch.core.config import ModelConfig

    m = dict(cfg["model"])
    m["dtype"] = DTYPES[m.get("dtype", "bfloat16")]
    return ModelConfig(name=cfg["name"], source=cfg["source"], **m)


def program_params(mcfg, weights: Dict[str, torch.Tensor]):
    """The program's parameter tree holding ``weights`` (no copy): its
    skeleton built on the meta device, each buffer replaced by the weight
    of the same path, shapes and dtypes checked."""
    from repro_torch.models import Model
    from repro_torch.models.transformer import param_leaves

    tree = Model(mcfg, device="meta").init_params(torch.Generator())
    seen = set()
    for path, owner, name, t in param_leaves(tree):
        w = weights.get(path)
        if w is None or tuple(w.shape) != tuple(t.shape) or w.dtype != t.dtype:
            raise ValueError(f"weight {path}: the program wants {tuple(t.shape)} {t.dtype}, "
                             f"the benchmark made {None if w is None else (tuple(w.shape), w.dtype)}")
        owner._buffers[name] = w
        seen.add(path)
    extra = set(weights) - seen
    if extra:
        raise ValueError(f"weights the program does not hold: {sorted(extra)[:4]}")
    return tree


def engine(mcfg, cfg: dict, device, verifier: Optional[str] = None):
    from repro_torch.core.config import SpecConfig
    from repro_torch.models import Model
    from repro_torch.serving.engine import SpecEngine

    e = dict(cfg["engine"])
    if verifier is not None:
        e["verifier"] = verifier
    return SpecEngine(Model(mcfg, device=device), SpecConfig(**e))


class Records:
    """What the serving loop's hooks report, on the benchmark's clock:
    per request (by the loop's ``rid``) its admission and streamed-token
    times, and per decode step its time, live rows, committed tokens and
    the live rows' summed context."""

    def __init__(self):
        self.admit: Dict[int, float] = {}
        self.emits: Dict[int, List[tuple]] = {}
        self.finish: Dict[int, float] = {}
        self.failed: Dict[int, float] = {}
        self.steps: List[tuple] = []         # (t, live rows, committed, context sum)
        self.admissions: List[tuple] = []    # (t, rid)
        self.context: Dict[int, int] = {}    # running rid -> committed length
        self.prompt_len: Dict[int, int] = {}


def recorder(records: Records, clock=time.perf_counter):
    """A ``ServerMetrics`` whose hooks also fill ``records``."""
    from repro_torch.serving.metrics import ServerMetrics

    class Recorder(ServerMetrics):
        def on_admit(self, rid, t):
            super().on_admit(rid, t)
            records.admit[rid] = t
            records.admissions.append((t, rid))
            records.context[rid] = records.prompt_len[rid]

        def on_tokens(self, rid, t, n):
            super().on_tokens(rid, t, n)
            records.emits.setdefault(rid, []).append((t, int(n)))
            records.context[rid] = records.context.get(rid, 0) + int(n)

        def on_finish(self, rid, t):
            super().on_finish(rid, t)
            records.finish[rid] = t
            records.context.pop(rid, None)

        def on_failed(self, rid, t):
            super().on_failed(rid, t)
            records.failed[rid] = t
            records.context.pop(rid, None)

        def on_decode_step(self, key, accepted, step_s):
            super().on_decode_step(key, accepted, step_s)
            records.steps.append((clock(), len(accepted), int(sum(accepted)),
                                  sum(records.context.values())))

    return Recorder(keep_timelines=False)


def serving_loop(eng, params, traffic, metrics, tracer=None):
    from repro_torch.serving.server import ServerConfig, ServingLoop

    scfg = ServerConfig(batch_slots=traffic.slots, max_prompt_len=traffic.max_prompt_len,
                        max_new_tokens=traffic.max_new_tokens, admission="fifo",
                        shed_late=False)
    return ServingLoop(eng, params, scfg, metrics=metrics, tracer=tracer)


def generation_request(req, seed: int):
    from repro_torch.serving.request import GenerationRequest

    return GenerationRequest(prompt=req.prompt, max_new_tokens=req.new_tokens, seed=seed)


def tracer():
    """The program's tracer with its spans on the profiler's timeline."""
    from repro_torch.serving.trace import Tracer

    return Tracer(annotate_device=True, max_events=200_000)
