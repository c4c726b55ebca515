"""Dry-run of every (arch × input shape) on the meta device: what it would
hold on each card under the sharding plan, whether that fits one 80 GB
H100, and its roofline terms — port of ``repro/launch/dryrun.py``.

  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--cards 4] [--verifier w8a8|w4a8|bf16]
      [--kv-cache bf16|int8] [--gamma 5] [--out dryrun.json]

For each combination it builds, on the meta device (shapes and dtypes,
nothing allocated, no card needed):

  train_4k     → bf16 params, AdamW's f32 moments, the token batch
  prefill_32k  → bf16 and prepared params, the cache, the prompt
  decode_32k   → bf16 and prepared params, the engine state
  long_500k      (``launch/shapes.serve_state_specs``)

and reports the bytes per card under ``launch/sharding.py``'s plan on a
``{"data": 1, "model": N}`` mesh (N = ``--cards``, 1 by default; 4 is the
tensor-parallel layout of one four-card host), whether that fits one card
(``roofline.HBM_BYTES``; activations and workspaces are not counted), the
:class:`~repro_torch.launch.roofline.Roofline` row and, for decode shapes,
``step_bound_ms``.  A serve shape keeps the bf16 params beside the prepared
ones, as the serving front-end does for its bf16 fallback lane.

The reference lowers and compiles each step for a 16×16 TPU mesh and
reads XLA's cost and memory analyses.  PyTorch has no counterpart of that
compile-only lowering, so this lowers and compiles nothing: the bytes come
from the meta tensors and the roofline from a count over shapes
(``launch/roofline.py``).  Executing a sharded step waits for a machine
with more than one visible card.  ``long_500k`` switches the
full-attention archs to a 4096-token sliding window: their state holds
ring caches of ``4096 + RING_PAD`` slots, and their step reads those.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import types

from repro_torch.launch import roofline as rf
from repro_torch.launch import shapes as shp
from repro_torch.launch import sharding as shd

def card_mesh(cards: int):
    """The plan's mesh: only its axis sizes are read, so no device is
    needed (``launch/mesh.make_mesh`` builds the real one)."""
    return types.SimpleNamespace(shape={"data": 1, "model": cards})


def _unique(*trees) -> list:
    """``[(path, tensor)]`` over parameter trees, each tensor once (a
    prepared tree shares its unquantized tensors with the raw one)."""
    seen, out = set(), []
    for tree in trees:
        for path, t in shd.param_leaves(tree):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((path, t))
    return out


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves)


def _params_bytes(leaves, mesh, fsdp=None, elem_bytes=None) -> int:
    """Bytes per card of parameter leaves under the plan (``elem_bytes``
    per element in place of each leaf's own: AdamW's f32 moments)."""
    return sum(t.numel() * (elem_bytes or t.element_size())
               // shd.shard_factor(shd.port_param_spec(path, tuple(t.shape), mesh, fsdp), mesh)
               for path, t in leaves)


def serve_resident_bytes(cfg, verifier: str, batch: int, buf_len: int) -> dict:
    """What a serving engine holds for ``batch`` rows of ``buf_len`` tokens
    on one card: the bf16 params, the prepared ones (tensors shared with
    the bf16 tree once) and the engine state (``init_state``)."""
    import torch

    from repro_torch.core.spec_engine import init_state
    from repro_torch.models.model import Model

    raw, prep = rf.meta_params(cfg, "bf16"), rf.meta_params(cfg, verifier)
    state = init_state(Model(cfg, device="meta"), batch, buf_len, [],
                       target=shp.meta_tensor((batch,), torch.int32))
    out = dict(raw_bytes=_nbytes(_unique(raw)),
               prepared_new_bytes=_nbytes(_unique(raw, prep)) - _nbytes(_unique(raw)),
               state_bytes=_nbytes(shd.tree_paths(state)))
    out["resident_bytes"] = sum(out.values())
    return out


def combo(arch: str, shape_name: str, cards: int = 1, verifier: str = "w8a8",
          kv_cache: str = "bf16", gamma: int = 5) -> dict:
    """One (arch × shape) row; raises on a fault."""
    from repro_torch.configs import get_config

    return combo_cfg(get_config(arch), shape_name, cards, verifier, kv_cache, gamma)


def combo_cfg(cfg, shape_name: str, cards: int = 1, verifier: str = "w8a8",
              kv_cache: str = "bf16", gamma: int = 5) -> dict:
    """:func:`combo` of a config (e.g. one cut in depth)."""
    from repro_torch.core.config import SpecConfig

    arch = cfg.name
    cfg = dataclasses.replace(shp.shape_cfg(cfg, shape_name), kv_cache_dtype=kv_cache)
    s = shp.SHAPES[shape_name]
    kind, B, T = s["kind"], s["global_batch"], s["seq_len"]
    mesh = card_mesh(cards)
    row = dict(arch=arch, shape=shape_name, kind=kind, cards=cards,
               mesh=f"1x{cards}", verifier="bf16" if kind == "train" else verifier,
               kv_cache=kv_cache)
    if cfg.sliding_window:
        row["sliding_window"] = cfg.sliding_window
    raw = rf.meta_params(cfg, "bf16")
    row["param_bytes"] = _nbytes(_unique(raw))
    if kind == "train":
        fsdp = ("data",)
        leaves = _unique(raw)
        floats = [(p, t) for p, t in leaves if t.is_floating_point()]
        row["opt_bytes"] = 2 * 4 * sum(t.numel() for _, t in floats)   # f32 μ and ν
        batch = shp.train_specs(cfg, shape_name)
        per_card = (_params_bytes(leaves, mesh, fsdp)
                    + 2 * _params_bytes(floats, mesh, fsdp, elem_bytes=4)        # μ, ν
                    + shd.bytes_per_card(shd.tree_paths(batch),
                                         shd.batch_shardings(batch, mesh), mesh))
        roof = rf.train_counts(cfg, B, T, cards)
    else:
        prep = rf.meta_params(cfg, verifier)
        row["prepared_bytes"] = _nbytes(_unique(prep))
        leaves = _unique(raw, prep)
        if kind == "prefill":
            spec = shp.prefill_specs(cfg, shape_name)
            state_specs = shd.state_shardings({"cache": spec["cache"]}, mesh)
            state_specs.update(shd.batch_shardings(
                {k: v for k, v in spec.items() if k != "cache"}, mesh))
            state = spec
            roof = rf.prefill_counts(cfg, verifier, B, T, cards)
        else:
            state = shp.serve_state_specs(cfg, shape_name, scfg=SpecConfig(gamma=gamma))
            state_specs = shd.state_shardings(state, mesh)
            roof = rf.step_counts(cfg, verifier, kv_cache, B, T, gamma + 1, cards)
            row["step_bound_ms"], row["bound_by"] = rf.step_bound_ms(
                cfg, verifier, kv_cache, B, T, gamma + 1)
            row["kv_capacity_gbytes"] = rf.kv_cache_capacity_bytes(cfg, [T] * B, T) / 1e9
            row["kv_capacity_paged_gbytes"] = None if cfg.sliding_window else \
                rf.kv_cache_capacity_bytes(cfg, [T] * B, T, layout="paged") / 1e9
        row["state_bytes"] = _nbytes(shd.tree_paths(state))
        per_card = _params_bytes(leaves, mesh) + shd.bytes_per_card(
            shd.tree_paths(state), state_specs, mesh)
    row.update(status="ok", bytes_per_card=per_card, fits_card=per_card <= rf.HBM_BYTES,
               **roof.row(), coll_breakdown_gb={k: v / 1e9
                                                for k, v in roof.coll_breakdown.items()})
    return row


def _line(row: dict) -> str:
    tag = f"{row['arch']} × {row['shape']} × {row['mesh']}"
    bound = (f" step_bound={row['step_bound_ms']:.3f}ms ({row['bound_by']})"
             if "step_bound_ms" in row else "")
    return (f"[ok] {tag}: {row['bytes_per_card'] / 1e9:.2f} GB/card "
            f"{'fits' if row['fits_card'] else 'DOES NOT FIT'} one card; "
            f"dominant={row['dominant']} t_mem={row['t_memory_s']:.3e}s "
            f"t_comp={row['t_compute_s']:.3e}s t_coll={row['t_collective_s']:.3e}s{bound}")


def run(archs, shape_names, cards: int = 1, verifier: str = "w8a8", kv_cache: str = "bf16",
        gamma: int = 5, log=print) -> tuple:
    """(rows, failures) over archs × shapes; a combo that raises is a
    failure."""
    rows, failures = [], []
    for arch in archs:
        for shape_name in shape_names:
            try:
                row = combo(arch, shape_name, cards, verifier, kv_cache, gamma)
            except Exception as exc:  # noqa: BLE001 — reported, counted, exit 1
                failures.append({"combo": f"{arch} × {shape_name} × 1x{cards}",
                                 "error": f"{type(exc).__name__}: {exc}"})
                log(f"[FAIL] {failures[-1]['combo']}: {failures[-1]['error']}")
                continue
            rows.append(row)
            log(_line(row))
    return rows, failures


def main(argv=None) -> int:
    from repro_torch.configs import REGISTRY

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=[None, *REGISTRY])
    ap.add_argument("--shape", default=None, choices=[None, *shp.SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cards", type=int, default=1)
    ap.add_argument("--verifier", default="w8a8", choices=["w8a8", "w4a8", "bf16"])
    ap.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--gamma", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if (args.all or not args.arch) else [args.arch]
    shape_names = list(shp.SHAPES) if (args.all or not args.shape) else [args.shape]
    rows, failures = run(archs, shape_names, args.cards, args.verifier, args.kv_cache,
                         args.gamma)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "failures": failures}, f, indent=1)
        print(f"wrote {len(rows)} rows ({len(failures)} failures) -> {args.out}")
    fits = sum(r["fits_card"] for r in rows)
    print(f"\n{len(rows)} ok ({fits} fit one card) / {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
