"""The port's launch tooling and its CLI and API parity against the JAX
package, on the CPU.

* ``active_param_count`` and the roofline functions over the config
  (``attn_layer_count``, ``kv_bytes_per_token``, ``kv_cache_read_bytes``,
  ``kv_cache_capacity_bytes``, ``model_flops_*``) equal the reference's for
  all 11 configs, both KV dtypes, both layouts, with a shared prefix; the
  decode step's byte and operation count holds the prepared weights.
* ``SHAPES``, ``LONG_WINDOW`` and ``shape_cfg`` are the reference's; the
  meta specs (``train_specs``, ``prefill_specs``, ``serve_state_specs``)
  have the shapes and dtypes of its ``jax.eval_shape`` specs.
* The sharding rules give the reference's ``_param_spec`` / ``_state_spec``
  / batch specs on the reference's mock meshes, over every leaf of each
  config's abstract params (full width, cut in depth), bf16, W8A8 and
  W4A8, the port's (N, K) int8/int4 storage mapped back; DTensor
  placements from a spec.
* The dry-run's bytes equal the byte sums of the reference's abstract
  leaves (bf16, W8A8, W4A8, AdamW's moments, the engine state); its CLI
  reports the ``long_500k`` combos through their ring caches.
* ``SpecEngine(mode=)`` and ``make_serve_step`` / ``make_vanilla_step`` /
  ``make_pruned_step`` give the reference's greedy tokens; the serve CLI's
  ``--mode spec --task humaneval`` over a reference checkpoint gives the
  reference engine's tokens and ``--drafter ngram``'s; ``--attn-impl jnp``
  equals ``auto`` on the CPU, ``pallas`` is refused there.
* The three ported examples run in process at reduced size.

``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` for 512 host
devices when imported.  The reference's abstract params are rebuilt as its
``build_params`` does, through ``jax.eval_shape``.
"""
import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.core.config import QuantConfig as JQuantConfig
from repro.core.config import SpecConfig as JSpecConfig
from repro.data import task_prompts as jtask_prompts
from repro.launch import roofline as jrf
from repro.launch import shapes as jshp
from repro.launch.sharding import _fit as j_fit
from repro.launch.sharding import _param_spec as j_param_spec
from repro.launch.sharding import _state_spec as j_state_spec
from repro.launch.sharding import _tree_paths as j_tree_paths
from repro.models import Model as JModel
from repro.quant import quantize_params as jquantize_params
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.train.checkpoint import save_checkpoint as jsave_checkpoint
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.spec_engine import make_pruned_step, make_serve_step, make_vanilla_step
from repro_torch.launch import dryrun, roofline as rf, shapes as shp, sharding as shd
from repro_torch.models import Model
from repro_torch.serving.engine import LEGACY_MODES, SpecEngine
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
MESHES = {"16x16": {"data": 16, "model": 16}, "pod": {"pod": 2, "data": 16, "model": 16},
          "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}
QUANT_ARCHS = ("quasar-paper-7b", "moonshot-v1-16b-a3b", "zamba2-2.7b", "whisper-small")
SPEC_ARCHS = ("smollm-135m", "zamba2-2.7b", "whisper-small", "llama-3.2-vision-90b")


def _mesh(name):
    return types.SimpleNamespace(shape=MESHES[name])


def _cut(name: str):
    """Full width, cut to one repeat of the layer pattern (both sides)."""
    cfg = JREGISTRY[name]
    depth = cfg.attn_every or cfg.cross_attn_every or 2
    return (dataclasses.replace(cfg, num_layers=depth),
            dataclasses.replace(get_config(name), num_layers=depth))


@functools.lru_cache(maxsize=None)
def _jax_abstract(name: str, verifier: str, scan: bool = False):
    """The reference's abstract params, as its dry-run's ``build_params``."""
    jcfg, _ = _cut(name)
    model = JModel(jcfg)

    def make():
        p = model.init_params(jax.random.PRNGKey(0))
        if verifier != "bf16":
            p = jquantize_params(p, None, JQuantConfig(w_bits=4 if verifier == "w4a8" else 8))
        return model.to_scan(p) if scan else p
    return jax.eval_shape(make)


def _jnbytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Counts over the config
# ---------------------------------------------------------------------------

def test_active_param_count_matches_jax():
    for name, jcfg in JREGISTRY.items():
        cfg = get_config(name)
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        assert cfg.reduced().active_param_count() == jcfg.reduced().active_param_count()


def test_roofline_functions_match_jax():
    for name, jcfg in JREGISTRY.items():
        cfg = get_config(name)
        assert rf.attn_layer_count(cfg) == jrf.attn_layer_count(jcfg), name
        assert rf.model_flops_train(cfg, 4096) == jrf.model_flops_train(jcfg, 4096)
        assert rf.model_flops_decode(cfg, 24) == jrf.model_flops_decode(jcfg, 24)
        for kv in ("bf16", "int8"):
            assert rf.kv_bytes_per_token(cfg, kv) == jrf.kv_bytes_per_token(jcfg, kv)
            assert rf.kv_cache_read_bytes(cfg, 4, 1056, kv) == \
                jrf.kv_cache_read_bytes(jcfg, 4, 1056, kv)
            for layout, bs, shared in (("contiguous", None, 0), ("paged", None, 0),
                                       ("paged", 16, 200), ("paged", 24, 37)):
                args = ([100, 300, 700, 1024], 1024, kv, layout, bs, shared)
                assert rf.kv_cache_capacity_bytes(cfg, *args) == \
                    jrf.kv_cache_capacity_bytes(jcfg, *args), (name, args)
    with pytest.raises(ValueError, match="unmodeled"):
        rf.kv_bytes_per_token(get_config("smollm-135m"), "fp8")


def test_step_counts_read_the_prepared_weights_once():
    """One 7B W8A8 chain step: the prepared weights (the embedding's window
    rows only), the KV cache to the committed context, the window's K/V
    written; 2·active·tokens operations, the quantized linears' in int8;
    the bound is the larger of bytes and operations over the peaks."""
    cfg = get_config("quasar-paper-7b")
    B, ctx, T = 4, 1056, 6
    prep = rf.meta_params(cfg, "w8a8")
    leaves = dict(shd.param_leaves(prep))
    emb = leaves["embed/w"]
    weights = sum(t.numel() * t.element_size() for t in leaves.values()) \
        - emb.numel() * emb.element_size() + B * T * cfg.d_model * 2
    kv = B * ctx * 32 * 2 * 1024 * 2
    r = rf.step_counts(cfg, "w8a8", "bf16", B, ctx, T)
    assert r.kv_bytes == kv
    assert r.bytes_accessed == weights + kv + B * T * 32 * 2 * 1024 * 2
    int8 = sum(t.numel() for p, t in leaves.items() if p.endswith("w_int8"))
    assert r.int8_flops == 2 * int8 * B * T
    assert r.model_flops == 2 * cfg.active_param_count() * B * T
    ms, by = rf.step_bound_ms(cfg, "w8a8", "bf16", B, ctx, T)
    assert (ms, by) == (r.bytes_accessed / rf.HBM_BW * 1e3, "bytes")
    assert rf.bound_ms(1e9, 1e15, "bf16") == (1e15 / 989e12 * 1e3, "operations")
    tied = get_config("smollm-135m")
    w = rf._weights(tied, rf.meta_params(tied, "bf16"), 24, decode=True)
    assert w.read == sum(t.numel() * t.element_size()
                         for _, t in shd.param_leaves(rf.meta_params(tied, "bf16")))
    one, four = (rf.step_counts(cfg, "w8a8", "bf16", B, ctx, T, cards) for cards in (1, 4))
    assert one.coll_bytes == 0 and four.coll_bytes > 0 and four.t_memory == one.t_memory / 4


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def _leaf_specs(tree) -> dict:
    """{path: (shape, dtype)} of a port tree (tensors) or a reference tree
    (the reference's ``key`` left out: the port's rows keep generators)."""
    leaves = shd.tree_paths(tree) or j_tree_paths(tree)[0]
    return {p: (tuple(x.shape), _dt(x)) for p, x in leaves if not p.startswith("key")}


def test_shapes_and_shape_cfg_match_jax():
    assert shp.SHAPES == jshp.SHAPES and shp.LONG_WINDOW == jshp.LONG_WINDOW
    for name, jcfg in JREGISTRY.items():
        for s in shp.SHAPES:
            assert shp.shape_cfg(get_config(name), s).sliding_window == \
                jshp.shape_cfg(jcfg, s).sliding_window, (name, s)
            if shp.SHAPES[s]["kind"] == "train":
                assert _leaf_specs(shp.train_specs(get_config(name), s)) == \
                    _leaf_specs(jshp.train_specs(jcfg, s)), name


@pytest.mark.parametrize("name", SPEC_ARCHS)
def test_meta_specs_match_jax_eval_shape(name):
    """The cache and the engine state (``init_state`` on the meta device),
    loop and scan layout, have the reference's shapes and dtypes; the
    reference's ``key`` is the port's per-row generators (no tensor)."""
    jcfg, cfg = JREGISTRY[name].reduced(), get_config(name).reduced()
    jmodel = JModel(jcfg)
    for scan in (False, True):
        got = shp.prefill_specs(cfg, "prefill_32k", scan=scan)
        want = jshp.prefill_specs(jcfg, "prefill_32k", jmodel, scan=scan)
        assert _leaf_specs(got) == _leaf_specs(want)
        got = shp.serve_state_specs(cfg, "decode_32k", scfg=SpecConfig(), scan=scan)
        want = jshp.serve_state_specs(jcfg, "decode_32k", jmodel, JSpecConfig(), scan=scan)
        assert got["generators"] == [] and "key" in want
        assert _leaf_specs(got) == _leaf_specs(want)
        assert all(t.device.type == "meta" for _, t in shd.tree_paths(got))
        # long_500k: ring caches (4096 + 128 slots and their kpos) for attention
        got = shp.serve_state_specs(shp.shape_cfg(cfg, "long_500k"), "long_500k",
                                    scfg=SpecConfig(), scan=scan)
        want = jshp.serve_state_specs(jshp.shape_cfg(jcfg, "long_500k"), "long_500k",
                                      JModel(jshp.shape_cfg(jcfg, "long_500k")),
                                      JSpecConfig(), scan=scan)
        assert _leaf_specs(got) == _leaf_specs(want)


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

def _swap(shape):
    return (*shape[:-2], shape[-1], shape[-2])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_jax(mesh):
    """Every leaf of each config's params (bf16 for all 11, W8A8 and W4A8
    for four) gets the reference's spec of the reference's leaf, the port's
    transposed int8/int4 leaves with their dims swapped back; with and
    without FSDP; the scan layout's leading dim replicated."""
    m = _mesh(mesh)
    fsdp_opts = (None, ("pod", "data") if mesh == "pod" else ("data",))
    cases = [(n, "bf16") for n in JREGISTRY] + [(n, v) for n in QUANT_ARCHS
                                               for v in ("w8a8", "w4a8")]
    for name, verifier in cases:
        _, cfg = _cut(name)
        want_leaves = dict(j_tree_paths(_jax_abstract(name, verifier))[0])
        got_leaves = dict(shd.param_leaves(rf.meta_params(cfg, verifier)))
        assert set(got_leaves) == set(want_leaves), (name, verifier)
        for fsdp in fsdp_opts:
            got = shd.param_shardings(rf.meta_params(cfg, verifier), m, fsdp)
            for path, leaf in want_leaves.items():
                t = got_leaves[path]
                swapped = path.rsplit("/", 1)[-1] in ("w_int8", "w_int4")
                assert (_swap(tuple(t.shape)) if swapped else tuple(t.shape)) == leaf.shape
                want = tuple(j_param_spec(path, leaf.shape, m, fsdp))
                assert (_swap(got[path]) if swapped and len(want) >= 2 else got[path]) == \
                    want, (name, verifier, path, fsdp)
    _, cfg = _cut("moonshot-v1-16b-a3b")
    stacked = Model(cfg, device="meta").to_scan(rf.meta_params(cfg, "w8a8"))
    want_leaves = dict(j_tree_paths(_jax_abstract("moonshot-v1-16b-a3b", "w8a8", True))[0])
    got = shd.param_shardings(stacked, m)
    for path, leaf in want_leaves.items():
        want = tuple(j_param_spec(path, leaf.shape, m, None))
        swapped = path.rsplit("/", 1)[-1] in ("w_int8", "w_int4")
        assert (_swap(got[path]) if swapped and len(want) >= 2 else got[path]) == want, path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_and_batch_specs_match_jax(mesh):
    m = _mesh(mesh)
    dp = tuple(a for a in MESHES[mesh] if a in ("pod", "data"))
    for name in SPEC_ARCHS:
        jcfg, cfg = JREGISTRY[name].reduced(), get_config(name).reduced()
        for scan in (False, True):
            state = jshp.serve_state_specs(jcfg, "decode_32k", JModel(jcfg), JSpecConfig(),
                                           scan=scan)
            got = shd.state_shardings(shp.serve_state_specs(cfg, "decode_32k", scan=scan), m)
            for path, leaf in j_tree_paths(state)[0]:
                if not path.startswith("key"):
                    assert got[path] == tuple(j_state_spec(path, leaf.shape, m, dp)), path
        batch = shd.batch_shardings(shp.train_specs(cfg, "train_4k"), m)
        for path, leaf in j_tree_paths(jshp.train_specs(jcfg, "train_4k"))[0]:
            want = (j_fit(m, leaf.shape[0], dp), *([None] * (len(leaf.shape) - 1)))
            assert batch[path] == want, path


def test_card_mesh_and_placements():
    """The one-card mesh (a single-process group on localhost, gloo on the
    CPU), its axes, and DTensor placements from a spec; a larger mesh
    needs its processes first."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as M

    with pytest.raises(RuntimeError, match="needs 4 processes"):
        M.make_mesh((2, 2), ("data", "model"), "cpu")
    m = M.make_card_mesh("cpu")
    try:
        assert M.axis_sizes(m) == {"data": 1, "model": 1} and M.data_axes(m) == ("data",)
        assert shd.placements((None, "model"), m) == [Replicate(), Shard(1)]
        assert shd.param_shardings(Model(_cut("smollm-135m")[1], device="meta").init_params(
            torch.Generator()), m)["layers/0/attn/o/w"] == (None, None)
    finally:
        dist.destroy_process_group()

    assert shd.placements((None, "model"), _mesh("1x4")) == [Replicate(), Shard(1)]
    assert M.data_axes(_mesh("pod")) == ("pod", "data")
    assert shd.placements((("pod", "data"), None, "model"), _mesh("pod")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((), _mesh("16x16")) == [Replicate(), Replicate()]
    assert shd.shard_factor((("pod", "data"), None, "model"), _mesh("pod")) == 512


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QUANT_ARCHS + ("llama-3.2-vision-90b",))
def test_dryrun_bytes_match_the_reference_abstract_leaves(name):
    """bf16, W8A8 and W4A8 params, AdamW's moments and the engine state:
    the dry-run's byte sums are the reference's abstract leaves' (full
    width, one repeat of the layer pattern)."""
    jcfg, cfg = _cut(name)
    raw = _jax_abstract(name, "bf16")
    for verifier in ("w8a8", "w4a8"):
        row = dryrun.combo_cfg(cfg, "decode_32k", verifier=verifier)
        assert row["param_bytes"] == _jnbytes(raw)
        assert row["prepared_bytes"] == _jnbytes(_jax_abstract(name, verifier))
        state = jshp.serve_state_specs(jcfg, "decode_32k", JModel(jcfg), JSpecConfig())
        assert row["state_bytes"] == _jnbytes(state) - _jnbytes(state["key"])
        # the prepared tree shares its unquantized leaves with the bf16 one
        raw_paths = dict(j_tree_paths(raw)[0])
        new = [x for p, x in j_tree_paths(_jax_abstract(name, verifier))[0]
               if p not in raw_paths]
        assert row["bytes_per_card"] == row["param_bytes"] + _jnbytes(new) + row["state_bytes"]
    row = dryrun.combo_cfg(cfg, "train_4k")
    opt = jax.eval_shape(jadamw_init, raw)
    assert row["opt_bytes"] == _jnbytes(opt["mu"]) + _jnbytes(opt["nu"])
    four = dryrun.combo_cfg(cfg, "train_4k", cards=4)
    assert four["bytes_per_card"] < row["bytes_per_card"]


def test_dryrun_cli_reports_rows_and_refusals(tmp_path, capsys):
    import json

    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "mamba2-370m", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["shape"] for r in rows] == list(shp.SHAPES)
    assert all(r["status"] == "ok" and r["fits_card"] for r in rows)
    assert rows[2]["bound_by"] == "bytes" and rows[2]["step_bound_ms"] > 0
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k", "--cards", "4",
                        "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[ok] smollm-135m × long_500k × 1x4:" in text
    assert "1 ok (1 fit one card) / 0 failed" in text
    (row,) = json.loads(out.read_text())["rows"]
    assert row["status"] == "ok" and row["sliding_window"] == 4096 and row["fits_card"]
    # the ring: 4096 + 128 slots of the 524288-token context read, held and counted
    cfg = shp.shape_cfg(get_config("smollm-135m"), "long_500k")
    assert rf.kv_slots(cfg, 524288) == 4224 and rf.kv_slots(cfg, 1000) == 1000
    assert row["kv_gbytes"] * 1e9 == rf.kv_cache_read_bytes(cfg, 1, 4224)
    assert row["kv_capacity_gbytes"] * 1e9 == rf.kv_cache_capacity_bytes(cfg, [1], 4096)
    assert row["kv_capacity_paged_gbytes"] is None


# ---------------------------------------------------------------------------
# Legacy modes and builders, the serve CLI's flags
# ---------------------------------------------------------------------------

N_NEW = 8


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = JREGISTRY["smollm-135m"].reduced()
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = get_config("smollm-135m").reduced()
    return jcfg, jparams, cfg, from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                               device="cpu")


def _prompts():
    return jtask_prompts("humaneval", 2, 24, 256)


@functools.lru_cache(maxsize=None)
def _jax_mode_tokens(mode: str):
    jcfg, jparams, _, _ = _setup()
    scfg = JSpecConfig(temperature=0.0, pruned_retention=0.5)
    r = JSpecEngine(JModel(jcfg), scfg, mode=mode).generate(jparams, jnp.asarray(_prompts()),
                                                            N_NEW)
    return np.asarray(r.tokens)[:, :24 + N_NEW]


@pytest.mark.parametrize("mode", list(LEGACY_MODES))
def test_legacy_modes_and_builders_give_the_reference_tokens(mode):
    """``SpecEngine(mode=)`` picks the drafter and the bf16 verifier as the
    reference's shim does, and the deprecated builder of that mode, run
    as the engine's step, gives the same greedy tokens: the reference's."""
    _, _, cfg, params = _setup()
    model = Model(cfg, device="cpu")
    scfg = SpecConfig(temperature=0.0, pruned_retention=0.5)
    eng = SpecEngine(model, scfg, mode=mode)
    assert (eng.drafter.name, eng.verifier.name) == (LEGACY_MODES[mode], "bf16")
    want = _jax_mode_tokens(mode)
    got = eng.generate(params, torch.from_numpy(_prompts()), N_NEW).tokens
    np.testing.assert_array_equal(got[:, :24 + N_NEW].numpy(), want)
    builder = {"spec": lambda: make_serve_step(model, scfg),
               "vanilla": lambda: make_vanilla_step(model, 0.0),
               "pruned": lambda: make_pruned_step(model, scfg, 0.5)}[mode]
    legacy = SpecEngine(model, scfg, mode=mode)
    legacy._step = legacy._counted(builder())
    got = legacy.generate(params, torch.from_numpy(_prompts()), N_NEW).tokens
    np.testing.assert_array_equal(got[:, :24 + N_NEW].numpy(), want)
    with pytest.raises(ValueError):
        SpecEngine(model, scfg, mode="beam")


def test_serve_cli_mode_and_task_give_the_reference_tokens(tmp_path, capsys):
    """``--mode spec`` maps to the ngram drafter only, as the reference's
    CLI does: under ``--verifier bf16`` over a reference checkpoint and
    ``--task humaneval`` prompts, the reference engine's tokens, and
    ``--drafter ngram``'s."""
    from repro_torch.data import task_prompts
    from repro_torch.launch import serve

    _, jparams, _, _ = _setup()
    ckpt = str(tmp_path / "ref.npz")
    jsave_checkpoint(ckpt, {"params": jparams, "step": 0})
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--ckpt", ckpt,
            "--verifier", "bf16", "--task", "humaneval", "--batch", "2", "--prompt-len", "24",
            "--new-tokens", str(N_NEW)]
    mode = serve.main(argv + ["--mode", "spec"])
    head = capsys.readouterr().out
    assert "drafter=ngram" in head and "attn=ref" in head
    drafter = serve.main(argv + ["--drafter", "ngram"])
    from repro_torch.data.synthetic import TASK_REPETITION

    for task in (*TASK_REPETITION, "another"):
        np.testing.assert_array_equal(task_prompts(task, 2, 24, 256),
                                      jtask_prompts(task, 2, 24, 256))
    np.testing.assert_array_equal(mode.tokens[:, :24 + N_NEW].numpy(), _jax_mode_tokens("spec"))
    assert torch.equal(mode.tokens, drafter.tokens)


@pytest.mark.parametrize("arch,layout", [("smollm-135m", "contiguous"),
                                         ("smollm-135m", "paged"),
                                         ("whisper-small", "contiguous")])
def test_serve_cli_attn_impl_jnp_equals_auto_on_cpu(arch, layout, capsys):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "24", "--new-tokens", str(N_NEW), "--kv-layout", layout]
    runs = {}
    for impl in ("auto", "jnp"):
        r = serve.main(argv + ["--attn-impl", impl])
        runs[impl] = [x.tokens for x in r.results] if layout == "paged" else [r.tokens]
        assert f"attn={'ref' if impl == 'auto' else 'jnp'}" in capsys.readouterr().out
    for a, b in zip(runs["auto"], runs["jnp"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(SystemExit):
        serve.main(argv + ["--attn-impl", "pallas"])
    assert "need the card" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The ported examples
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_run_reduced_on_cpu(tmp_path, capsys):
    out = _example("quickstart").main(["--device", "cpu", "--steps", "2",
                                       "--new-tokens", str(N_NEW)])
    assert out["lossless"] and out["steps"] <= out["vanilla_steps"]
    out = _example("quantize_and_inspect").main(["--device", "cpu", "--steps", "2"])
    assert set(out) == {"alpha=0.0", "alpha=0.5", "alpha=0.8", "no calib"}
    assert all(np.isfinite(kl) and 0.0 <= t1 <= 1.0 for kl, t1 in out.values())
    ckpt = tmp_path / "small.npz"
    out = _example("train_small").main(["--device", "cpu", "--steps", "2", "--batch", "2",
                                        "--seq-len", "16", "--ckpt", str(ckpt)])
    assert ckpt.exists() and np.isfinite(out["history"][-1]["loss"])
    assert "lossless vs autoregressive quantized model: True" in capsys.readouterr().out
