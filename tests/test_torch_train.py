"""The port's training (``repro_torch/train``, ``launch/train.py``, the
serve CLI's ``--ckpt``, ``data.lm_batches`` / ``ambiguous_prompts``)
against the JAX package, on the CPU, at ``.reduced()`` f32 configs with the
reference's weights bridged as numpy.

Tolerances:
* ``lm_batches``, ``ambiguous_prompts``, the trainable-leaf census and
  checkpoints: exact.
* AdamW on identical params and grads: params, ``mu``, ``nu`` and ``lr``
  bit-equal below the clip (the port takes the reference's compiled
  arithmetic: XLA contracts each product into the sum that reads it and
  folds ``(m/c1)/den`` into ``m/(c1·den)``); ``grad_norm`` within 2 ulp,
  because XLA's vectorized reduction sums each leaf in another order than
  torch's; above the clip the scale carries that difference, so there
  rtol 1e-5 of each tensor's largest value.
* ``loss_fn``: loss, ce and aux within rtol 1e-5; every leaf's gradient
  within 2e-5 of that leaf's largest value, plus 1e-6 of the largest
  gradient of the tree (a bias of cross-attention's k gets a gradient that
  is 0 up to rounding: softmax ignores a shift shared by every key).
* Remat against no remat: bit for bit.
* The loss over 5 ``Trainer`` steps: rtol 1e-5 (Adam's sign-like first
  step turns ulp differences of the gradients into differences of whole
  steps in a few params, so the losses are compared, not the params).
* The serve CLI on a reference-saved checkpoint: the reference engine's
  greedy tokens, exactly.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.core.config import SpecConfig as JSpecConfig
from repro.data import ambiguous_prompts as jambiguous_prompts
from repro.data import lm_batches as jlm_batches
from repro.data import task_prompts as jtask_prompts
from repro.models import Model as JModel
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.bridge import from_jax_params, tensor, to_numpy, to_tree
from repro_torch.configs import get_config
from repro_torch.data import ambiguous_prompts, lm_batches
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.kernels.ssd_update import ssd_update_ref
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.model import forward
from repro_torch.train import checkpoint, optimizer
from repro_torch.train.trainer import Trainer, train_leaves, value_and_grad
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parent.parent / "src"
GRAD_RTOL, GRAD_FLOOR, LOSS_RTOL = 2e-5, 1e-6, 1e-5
# (arch, T): dense, MoE (aux > 0), the SSM's sequential (T <= 16) and
# chunked paths, and the two models that read aux embeddings
LOSS_CASES = [("smollm-135m", 12), ("phi3.5-moe-42b-a6.6b", 12), ("mamba2-370m", 8),
              ("mamba2-370m", 32), ("llama-3.2-vision-90b", 12), ("whisper-small", 12)]


def _cfgs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's weights (numpy), vision's cross gates at 0.5 (at 0
    a cross layer adds nothing)."""
    tree = jax.tree.map(np.array, JModel(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0)))
    for lp in tree["layers"]:
        if "gate_attn" in lp:
            lp["gate_attn"] = np.asarray(0.5, np.float32)
            lp["gate_ffn"] = np.asarray(0.5, np.float32)
    return tree


def _batch(arch, T, B=2, seed=0):
    cfg = _cfgs(arch)[1]
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(-1, cfg.vocab_size, (B, T)).astype(np.int32)}
    n = cfg.num_image_tokens or cfg.num_audio_frames
    if n:
        batch["aux_embeds"] = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return batch


def _ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,alpha", [(0, 0.9), (0, 0.97), (1, 0.97), (7, 0.9)])
def test_lm_batches_bit_equal(seed, alpha):
    want, got = jlm_batches(3, 40, 500, seed, alpha), lm_batches(3, 40, 500, seed, alpha)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_ambiguous_prompts_bit_equal(seed):
    for data_seed in (0, 2):
        want = jambiguous_prompts(4, 64, 300, seed=seed, data_seed=data_seed)
        got = ambiguous_prompts(4, 64, 300, seed=seed, data_seed=data_seed)
        assert want.dtype == got.dtype and np.array_equal(want, got)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT_SHAPES = {"a": (64, 32), "b": (37,), "c": (8, 17, 3), "d": (1,), "e": (5, 3)}


def _opt_pair(**kw):
    return jopt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)


def _run_adamw(grad_std, steps=6, **kw):
    """Both optimizers on the same f32 (and one bf16) params and grads →
    per step (jax params, opt, metrics), (port params, opt, metrics)."""
    jcfg, pcfg = _opt_pair(lr=1e-3, warmup_steps=3, total_steps=20, **kw)
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in OPT_SHAPES.items()}
    params["f"] = rng.standard_normal((6, 9)).astype(ml_dtypes.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: tensor(v, "cpu") for k, v in params.items()}
    jo, po = jopt.adamw_init(jp), optimizer.adamw_init(pp)
    upd = jax.jit(lambda p, g, o: jopt.adamw_update(jcfg, p, g, o))
    out = []
    for step in range(steps):
        grads = {k: (rng.standard_normal(np.shape(v)) * grad_std[step % 2]).astype(np.float32)
                 for k, v in params.items()}
        jp, jo, jm = upd(jp, {k: jnp.asarray(v) for k, v in grads.items()}, jo)
        pp, po, pm = optimizer.adamw_update(
            pcfg, pp, {k: torch.from_numpy(v) for k, v in grads.items()}, po)
        out.append(((jp, jo, jm), (pp, po, pm)))
    return out


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_adamw_update_matches_jax_below_the_clip():
    for (jp, jo, jm), (pp, po, pm) in _run_adamw((0.001, 0.003)):
        assert np.float32(jm["lr"]) == np.float32(pm["lr"])
        assert _ulps(jm["grad_norm"], pm["grad_norm"].numpy()) <= 2
        assert float(pm["grad_norm"]) < 1.0
        for k in jp:
            assert pp[k].dtype == (torch.bfloat16 if k == "f" else torch.float32)
            assert _ulps(_f32(jp[k]), _f32(pp[k])) == 0, k
            assert _ulps(jo["mu"][k], po["mu"][k].numpy()) == 0, k
            assert _ulps(jo["nu"][k], po["nu"][k].numpy()) == 0, k
        assert int(jo["step"]) == po["step"]


def test_adamw_update_matches_jax_above_the_clip():
    for (jp, jo, jm), (pp, po, pm) in _run_adamw((3.0, 0.1)):
        assert _ulps(jm["grad_norm"], pm["grad_norm"].numpy()) <= 2
        for want, got in [(jp, pp), (jo["mu"], po["mu"]), (jo["nu"], po["nu"])]:
            for k in want:
                w, g = _f32(want[k]), _f32(got[k])
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                           err_msg=k)


def test_cosine_lr_at_the_reference_points():
    jcfg, pcfg = _opt_pair(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(optimizer.cosine_lr(pcfg, 5)) == 0.5
    assert abs(float(optimizer.cosine_lr(pcfg, 10)) - 1.0) < 1e-6
    assert float(optimizer.cosine_lr(pcfg, 110)) < 1e-6
    for step in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 200):
        assert (np.float32(optimizer.cosine_lr(pcfg, step))
                == np.float32(jopt.cosine_lr(jcfg, jnp.int32(step)))), step


def test_grad_clip_bounds_update():
    cfg = optimizer.AdamWConfig(lr=1.0, grad_clip=1e-6, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones((4, 4))}
    p2, _, m = optimizer.adamw_update(cfg, params, {"w": torch.full((4, 4), 1e6)},
                                      optimizer.adamw_init(params))
    assert float(m["grad_norm"]) > 1e5
    assert float((p2["w"] - params["w"]).abs().max()) < 1.5      # clipped step


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, T):
    jcfg = _cfgs(arch)[0]
    b = _batch(arch, T)
    aux = jnp.asarray(b["aux_embeds"]) if "aux_embeds" in b else None
    fn = jax.jit(jax.value_and_grad(jtrainer.loss_fn, has_aux=True), static_argnums=1)
    (loss, (ce, aux_l)), grads = fn(jax.tree.map(jnp.asarray, _jax_params(arch)), jcfg,
                                    jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), aux)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(grads)[0]]
    return (float(loss), float(ce), float(aux_l)), paths, [np.asarray(g) for g in
                                                          jax.tree.leaves(grads)]


def _ref_path(keystr: str) -> str:
    """``['layers'][0]['attn']['q']['w']`` → ``layers/0/attn/q/w``."""
    return "/".join(p.strip("'") for p in keystr.strip("[]").split("]["))


@pytest.mark.parametrize("arch,T", LOSS_CASES)
def test_loss_and_grads_match_jax(arch, T):
    (loss, ce, aux), paths, jgrads = _jax_value_and_grad(arch, T)
    params = from_jax_params(_jax_params(arch), _cfgs(arch)[1], device="cpu")
    (pl, (pce, paux)), grads = value_and_grad(params, _cfgs(arch)[1], _batch(arch, T))
    np.testing.assert_allclose([float(pl), float(pce), float(paux)], [loss, ce, aux],
                               rtol=LOSS_RTOL)
    if arch.startswith("phi3.5"):
        assert aux > 0
    assert list(grads) == [_ref_path(p) for p in paths]
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in jgrads)
    for (name, got), want in zip(grads.items(), jgrads):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max() + floor, err_msg=name)


@pytest.mark.parametrize("dt", [0.05, 1.0])
def test_chunked_ssd_gradient_is_finite_where_the_reference_overflows(dt):
    """The chunked SSD's intra-chunk decay above the diagonal overflows exp
    once a chunk's Σ dt·A passes ~88: the reference's gradient is then NaN
    (``where(tri, exp(decay), 0)``: 0 · ∞), the port's stays finite.  The
    outputs agree, and so do the gradients where the reference's are
    finite."""
    from repro.models.ssm import _ssd_chunked
    from repro_torch.models.ssm import ssd_chunked

    rng = np.random.default_rng(0)
    B, T, H, P, N = 1, 16, 2, 4, 4
    x, bm, cm = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, P), (B, T, N), (B, T, N)))
    a, h0 = np.array([1.0, 16.0], np.float32), np.zeros((B, H, P, N), np.float32)
    dts = np.full((B, T, H), dt, np.float32)
    ref = lambda d: jnp.sum(_ssd_chunked(*map(jnp.asarray, (x, bm, cm)), d,  # noqa: E731
                                         jnp.asarray(a), jnp.asarray(h0), T)[0])
    want, jgrad = jax.value_and_grad(ref)(jnp.asarray(dts))
    d = torch.from_numpy(dts).requires_grad_(True)
    y, _ = ssd_chunked(*map(torch.from_numpy, (x, bm, cm)), d, torch.from_numpy(a),
                       torch.from_numpy(h0), T)
    (grad,) = torch.autograd.grad(y.sum(), d)
    np.testing.assert_allclose(float(y.detach().sum()), float(want), rtol=1e-5)
    assert bool(torch.isfinite(grad).all())
    if dt * 16 * T < 88:
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    else:
        assert not bool(jnp.isfinite(jgrad).all())


@pytest.mark.parametrize("arch,T", [("phi3.5-moe-42b-a6.6b", 12), ("mamba2-370m", 32),
                                    ("whisper-small", 12), ("zamba2-2.7b", 12)])
def test_remat_is_bit_equal_to_no_remat(arch, T):
    params = from_jax_params(_jax_params(arch), _cfgs(arch)[1], device="cpu")
    (l0, (c0, a0)), g0 = value_and_grad(params, _cfgs(arch)[1], _batch(arch, T), remat=False)
    (l1, (c1, a1)), g1 = value_and_grad(params, _cfgs(arch)[1], _batch(arch, T), remat=True)
    assert torch.equal(l0, l1) and torch.equal(c0, c1) and torch.equal(a0, a1)
    assert list(g0) == list(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_train_leaves_are_the_reference_leaves(arch):
    """Names, shapes and dtypes of the trainable leaves equal the
    reference's ``jax.tree.leaves(init_params)``: none missing, no derived
    table among them."""
    jcfg, pcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: JModel(jcfg).init_params(jax.random.PRNGKey(0)))
    want = [(_ref_path(jax.tree_util.keystr(p)), tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    params = Model(pcfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    got = [(k, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in train_leaves(params).items()]
    assert got == want


def test_calibration_and_the_plain_gradient_route():
    """A calibration forward records no graph, even on leaves that need a
    gradient; the route the card takes for ``ssd_update`` and the cross
    read (kernel forward, plain version's gradient backward), run here with
    the plain version standing in for the kernel, gives autograd's
    gradients."""
    arch = "smollm-135m"
    params = from_jax_params(_jax_params(arch), _cfgs(arch)[1], device="cpu")
    for t in train_leaves(params).values():
        t.requires_grad_(True)
    collect = {}
    logits, _ = forward(params, torch.from_numpy(_batch(arch, 8)["tokens"]), collect=collect)
    assert not logits.requires_grad and collect
    assert not any(v.requires_grad for v in collect.values())

    rng = np.random.default_rng(0)
    B, T, H, P, N = 2, 6, 3, 16, 16
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    ssd_in = [t(B, T, H, P), t(B, T, N), t(B, T, N), t(B, T, H).abs() * 0.1,
              t(H).abs() + 0.5, t(B, H, P, N)]
    ssd_plain = lambda *a: ssd_update_ref(*a, True)  # noqa: E731
    q, k, v = t(B, T, 4, 32), t(B, 10, 2, 32), t(B, 10, 2, 32)
    qpos = torch.full((B, T), 9, dtype=torch.int32)
    cross_plain = lambda q, k, v: flash_decode_ref(q, k, v, qpos)  # noqa: E731
    for plain, inputs in ((ssd_plain, ssd_in), (cross_plain, [q, k, v])):
        def grads(route):
            xs = [x.detach().requires_grad_(True) for x in inputs]
            outs = route(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            loss = sum((o * torch.linspace(-1, 1, o.numel()).view(o.shape)).sum() for o in outs)
            return torch.autograd.grad(loss, xs)

        kernel = lambda *a, _p=plain: _p(*a)  # noqa: E731
        got = grads(lambda *xs: ops._PlainGrad.apply(kernel, plain, *xs))
        for a, b in zip(got, grads(plain)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The trainer and the train CLI
# ---------------------------------------------------------------------------

STEPS = 5


@pytest.fixture(scope="module")
def jax_trained():
    """The reference's Trainer, STEPS steps on smollm-135m reduced from the
    shared weights: (params, history)."""
    jcfg = _cfgs("smollm-135m")[0]
    tr = jtrainer.Trainer(JModel(jcfg), jopt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                         total_steps=20))
    params = jax.tree.map(jnp.asarray, _jax_params("smollm-135m"))
    params, _, hist = tr.fit(params, jopt.adamw_init(params),
                             jlm_batches(4, 32, jcfg.vocab_size, seed=0), steps=STEPS,
                             log_every=1, log_fn=None)
    return params, hist


def test_trainer_loss_trajectory_matches_jax(jax_trained):
    _, jhist = jax_trained
    pcfg = _cfgs("smollm-135m")[1]
    tr = Trainer(Model(pcfg, device="cpu"), optimizer.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                                  total_steps=20), remat=True)
    params = from_jax_params(_jax_params("smollm-135m"), pcfg, device="cpu")
    params, opt, hist = tr.fit(params, optimizer.adamw_init(train_leaves(params)),
                               lm_batches(4, 32, pcfg.vocab_size, seed=0), steps=STEPS,
                               log_every=1, log_fn=None)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == list(range(1, STEPS + 1))
    for key in ("loss", "ce", "lr", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hist], [h[key] for h in jhist],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert opt["step"] == STEPS
    assert not any(t.requires_grad for t in params.buffers())


def test_loss_decreases():
    cfg = get_config("smollm-135m").reduced()
    tr = Trainer(Model(cfg, device="cpu"),
                 optimizer.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60))
    params, opt = tr.init(torch.Generator().manual_seed(0))
    params, opt, hist = tr.fit(params, opt, lm_batches(8, 64, cfg.vocab_size, seed=0),
                               steps=30, log_every=10, log_fn=None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.05


def test_train_cli_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-135m",
         "--reduced", "--steps", "3", "--batch", "2", "--seq-len", "32", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=SRC.parent,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loss" in out.stdout and "layout=loop device=CPU" in out.stdout


def test_train_cli_run_is_the_trainers(tmp_path):
    """The CLI's ``--warmup``/``--markov-alpha`` reach the schedule and the
    corpus: its per-step losses and gradient norms are ``Trainer.fit``'s on
    the same recipe, bit for bit, and its checkpoint holds the trained
    leaves."""
    from repro_torch.launch import train

    path = str(tmp_path / "run.npz")
    run = train.main(["--arch", "smollm-135m", "--reduced", "--steps", "4", "--batch", "2",
                      "--seq-len", "16", "--lr", "2e-3", "--warmup", "2", "--markov-alpha",
                      "0.97", "--device", "cpu", "--ckpt", path])
    cfg = get_config("smollm-135m").reduced()
    opt_cfg = optimizer.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=4)
    assert run.opt_cfg == opt_cfg and len(run.step_s) == 4 and run.peak_gb is None
    tr = Trainer(Model(cfg, device="cpu"), opt_cfg, remat=True)
    params, opt = tr.init(torch.Generator().manual_seed(train.WEIGHT_SEED))
    params, opt, hist = tr.fit(params, opt, lm_batches(2, 16, cfg.vocab_size, seed=0,
                                                        markov_alpha=0.97),
                               steps=4, log_every=1, log_fn=None)
    assert run.losses == [h["loss"] for h in hist]
    assert run.grad_norms == [h["grad_norm"] for h in hist]
    assert run.last10 == pytest.approx(np.mean(run.losses))
    back = from_jax_params(checkpoint.load_checkpoint(path)["params"], cfg, device="cpu")
    want, got = train_leaves(params), train_leaves(back)
    assert list(want) == list(got) and all(torch.equal(want[k], got[k]) for k in want)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_f32_checkpoint_from_the_reference(tmp_path):
    jcfg = jget_config("zamba2-2.7b").reduced()
    params = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    path = os.path.join(tmp_path, "ckpt.npz")
    jckpt.save_checkpoint(path, {"params": params, "opt": jopt.adamw_init(params), "step": 7})
    back = checkpoint.load_checkpoint(path)
    _tree_equal(back["params"], jax.tree.map(np.asarray, params))
    assert int(back["step"]) == 7 and isinstance(back["params"]["layers"], list)
    assert len(back["params"]["layers"]) == jcfg.num_layers
    pcfg = get_config("zamba2-2.7b").reduced()
    _tree_equal(to_numpy(from_jax_params(back["params"], pcfg, device="cpu")),
                jax.tree.map(np.asarray, params))


def test_f32_checkpoint_to_the_reference(tmp_path):
    pcfg = get_config("zamba2-2.7b").reduced()
    params = Model(pcfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    opt = optimizer.adamw_init(train_leaves(params))
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save_checkpoint(path, {"params": to_tree(params), "opt": opt, "step": 7})
    back = jckpt.load_checkpoint(path)
    _tree_equal(back["params"], to_numpy(params))
    assert int(back["step"]) == 7 and isinstance(back["params"]["layers"], list)
    assert int(back["opt"]["step"]) == 0
    assert sorted(back["opt"]["mu"]) == sorted(train_leaves(params))


def test_bf16_checkpoint_from_the_reference_loads_bit_equal(tmp_path):
    """The reference writes bf16 leaves as 2-byte voids (``|V2``), which
    its own loader cannot read back; the port reads them as bf16, and its
    own bf16 checkpoints round-trip."""
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, JModel(jcfg).init_params(jax.random.PRNGKey(0)))
    assert params["embed"]["w"].dtype.name == "bfloat16"
    path = os.path.join(tmp_path, "bf16.npz")
    jckpt.save_checkpoint(path, {"params": params, "step": 3})
    back = checkpoint.load_checkpoint(path)
    assert back["params"]["embed"]["w"].dtype == np.dtype("V2")
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype=torch.bfloat16)
    port = from_jax_params(back["params"], pcfg, device="cpu")
    assert port.embed.w.dtype == torch.bfloat16
    _tree_equal(to_numpy(port), params)
    again = os.path.join(tmp_path, "again.npz")
    checkpoint.save_checkpoint(again, {"params": to_tree(port), "step": 3})
    _tree_equal(checkpoint.load_checkpoint(again), back)


def test_serve_ckpt_gives_the_reference_engines_tokens(jax_trained, tmp_path):
    """The port's serve CLI on a checkpoint the reference trained and saved:
    the reference engine's greedy tokens on the same prompts."""
    params, _ = jax_trained
    path = os.path.join(tmp_path, "trained.npz")
    jckpt.save_checkpoint(path, {"params": params, "step": STEPS})
    B, P, NEW = 2, 24, 8
    r = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--ckpt", path,
                    "--verifier", "w8a8", "--drafter", "ngram", "--batch", str(B),
                    "--prompt-len", str(P), "--new-tokens", str(NEW)])
    jcfg = _cfgs("smollm-135m")[0]
    prompts = jtask_prompts(serve.TASK, B, P, jcfg.vocab_size)
    want = JSpecEngine(JModel(jcfg), JSpecConfig(gamma=5, drafter="ngram",
                                                 verifier="w8a8")).generate(
        params, jnp.asarray(prompts), NEW)
    np.testing.assert_array_equal(r.tokens.numpy(), np.asarray(want.tokens))
