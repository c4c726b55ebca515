"""The reference's stacked ("scan") layout in the port, against the JAX
package, on the CPU: ``scan_pattern``; ``Model.to_scan`` leaf for leaf
against ``repro.models.Model.to_scan`` (params and caches) for the families
of ``tests/test_scan.py``; ``stack_params``/``unstack_params`` and
``stack_cache``/``unstack_cache`` round trips, the unstacked leaves views of
the stacked ones; the bridge from a reference scan tree equal to the bridge
from its loop tree; a scan cache driven through ``Model`` in place; and
``serve --ckpt`` on a reference checkpoint in the scan layout giving its
loop-layout twin's tokens.  The port runs no stacked forward
(``models/scan.py``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models.scan import scan_pattern as jscan_pattern
from repro.train.checkpoint import save_checkpoint as jsave_checkpoint
from repro_torch.bridge import array, from_jax_params, to_numpy
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import scan as S
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

FAMS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "mamba2-370m", "zamba2-2.7b",
        "llama-3.2-vision-90b", "whisper-small"]


def _flat(tree, prefix="") -> dict:
    """{path: numpy} of a nested dict/list of arrays or tensors."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: array(tree) if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax(arch):
    cfg = jget_config(arch).reduced()
    return JModel(cfg), JModel(cfg).init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port(arch):
    _, jparams = _jax(arch)
    cfg = get_config(arch).reduced()
    return Model(cfg, device="cpu"), from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                                     device="cpu")


def test_scan_pattern_matches_jax():
    for name, jcfg in JREGISTRY.items():
        for cfg, ref in ((get_config(name), jcfg), (get_config(name).reduced(), jcfg.reduced())):
            assert S.scan_pattern(cfg) == jscan_pattern(ref), name


@pytest.mark.parametrize("arch", FAMS)
def test_to_scan_matches_jax_leaf_for_leaf(arch):
    """Params (from the port's ``Transformer``) and caches (both layouts
    of ``init_cache``) stack as the reference's ``Model.to_scan`` does."""
    jmodel, jparams = _jax(arch)
    model, params = _port(arch)
    _assert_same(_flat(model.to_scan(params)), _flat(jmodel.to_scan(jparams)))
    jcache = jmodel.init_cache(2, 40)
    cache = model.init_cache(2, 40)
    _assert_same(_flat(model.to_scan(cache)), _flat(jmodel.to_scan(jcache)))
    _assert_same(_flat(model.init_cache(2, 40, scan=True)),
                 _flat(jmodel.init_cache(2, 40, scan=True)))


@pytest.mark.parametrize("arch", FAMS)
def test_stack_unstack_round_trip_as_views(arch):
    model, params = _port(arch)
    cfg = model.cfg
    tree = model.to_scan(params)
    back = S.unstack_params(tree, cfg)
    _assert_same(_flat(back), _flat(to_numpy(params)))
    stacked = tree["scan"][0]
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    layer = back["layers"][0]
    while isinstance(layer, dict):
        layer = next(iter(layer.values()))
    assert layer.untyped_storage().data_ptr() == stacked.untyped_storage().data_ptr()
    cache = model.init_cache(2, 40)
    _assert_same(_flat(S.unstack_cache(S.stack_cache(cache, cfg), cfg)), _flat(cache))


@pytest.mark.parametrize("arch", FAMS)
def test_bridge_from_a_scan_tree_equals_the_loop_tree(arch):
    """``from_jax_params`` unstacks a reference scan tree: the same port
    parameters as from the loop tree, leaf for leaf."""
    jmodel, jparams = _jax(arch)
    cfg = get_config(arch).reduced()
    stacked = jax.tree.map(np.asarray, jmodel.to_scan(jparams))
    loop = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    _assert_same(_flat(to_numpy(from_jax_params(stacked, cfg, device="cpu"))),
                 _flat(to_numpy(loop)))
    _assert_same(_flat(to_numpy(Model(cfg, device="cpu").params_from_tree(stacked))),
                 _flat(to_numpy(loop)))


def test_scan_cache_through_the_model_writes_the_stacked_tensors():
    """A cache in the scan layout goes through ``Model.prefill`` and
    ``verify_step`` as per-layer views: the same logits as the loop
    layout, and the prefill's K/V land in the stacked tensors."""
    model, params = _port("smollm-135m")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32))
    start = torch.full((2,), 5, dtype=torch.int32)
    outs = []
    for scan in (False, True):
        cache = model.init_cache(2, 40, scan=scan)
        model.prefill(params, cache, toks[:, :5])
        logits, _ = model.verify_step(params, cache, toks[:, 5:], start)
        outs.append((logits, cache))
    assert torch.equal(outs[0][0], outs[1][0])
    _assert_same(_flat(S.unstack_cache(outs[1][1], model.cfg)), _flat(outs[0][1]))
    assert outs[1][1]["scan"][0]["k"].abs().sum() > 0


def test_serve_ckpt_in_the_scan_layout_gives_the_loop_layout_tokens(tmp_path, capsys):
    """The reference's train CLI saves the scan layout for more than 8
    layers; its own ``serve --ckpt`` cannot serve that file (ROADMAP §3).
    The port's serves it through the bridge: the same tokens as the
    loop-layout checkpoint of the same weights."""
    from repro_torch.launch import serve

    jmodel, jparams = _jax("smollm-135m")
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "24", "--new-tokens", "8"]
    runs = {}
    for layout, tree in (("loop", jparams), ("scan", jmodel.to_scan(jparams))):
        path = str(tmp_path / f"{layout}.npz")
        jsave_checkpoint(path, {"params": tree, "step": 1})
        runs[layout] = serve.main(argv + ["--ckpt", path]).tokens
    assert torch.equal(runs["scan"], runs["loop"])
    assert capsys.readouterr().out.count("serving ") == 2
