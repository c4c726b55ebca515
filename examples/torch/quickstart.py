"""Quickstart on the PyTorch/CUDA port: the full Quasar pipeline.

1. train a small llama-family model (smollm-135m) on a synthetic corpus,
2. calibrate + quantize it to W8A8 (enhanced SmoothQuant, paper §3.2-3.3),
3. serve with quantized self-speculative decoding (n-gram drafting + W8A8
   verification) and check the output is exactly what the quantized model
   would have produced autoregressively (the lossless guarantee).

Runs on the CUDA card by default, where step 3 goes through the
hand-written kernels (``norm_smooth_quant``/``smooth_quant``,
``int8_matmul``, ``flash_decode``); ``--device cpu`` runs their plain
versions.  ``--full`` takes smollm-135m at full width; the default is its
``.reduced()`` config.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--full]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import QuantConfig, SpecConfig
from repro_torch.data import lm_batches, task_prompts
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.quant.apply import quantize_params
from repro_torch.serving.engine import SpecEngine
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="smollm-135m at full width")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("smollm-135m")
    if not args.full:
        cfg = cfg.reduced()
    model = Model(cfg, device=dev)

    print("== 1. train ==")
    trainer = Trainer(model, AdamWConfig(lr=1.5e-3, warmup_steps=min(10, args.steps // 5),
                                         total_steps=args.steps))
    params, opt = trainer.init(torch.Generator(device=dev).manual_seed(0))
    params, _, _ = trainer.fit(params, opt, lm_batches(8, 96, cfg.vocab_size, seed=0),
                               steps=args.steps, log_every=40)

    print("\n== 2. calibrate + quantize (offline weight preparation) ==")
    collect = {}
    calib = next(lm_batches(4, 96, cfg.vocab_size, seed=1))
    model.forward(params, torch.as_tensor(calib["tokens"], device=dev), collect=collect)
    qparams = quantize_params(params, collect, QuantConfig())
    print(f"calibrated {len(collect)} linear apply-sites; "
          "weights now int8 + per-channel scales")

    print("\n== 3. serve with quantized verification ==")
    # drafter/verifier are registry plugins; the "vanilla" drafter (γ=0)
    # is the autoregressive baseline through the same unified decode step
    prompts = torch.as_tensor(task_prompts("gsm8k", 2, 48, cfg.vocab_size), device=dev)
    scfg = SpecConfig(gamma=5, temperature=0.0)
    n = args.new_tokens
    with torch.inference_mode():
        quasar = SpecEngine(model, scfg, drafter="ngram",
                            verifier="bf16").generate(qparams, prompts, n)
        vanilla = SpecEngine(model, scfg, drafter="vanilla",
                             verifier="bf16").generate(qparams, prompts, n)

    P = prompts.shape[1]
    lossless = bool(torch.equal(quasar.tokens[:, :P + n], vanilla.tokens[:, :P + n]))
    print(f"mean acceptance length L = {quasar.mean_accept_len:.2f}")
    print(f"verifier passes: {quasar.steps} (vanilla needed {vanilla.steps})")
    print(f"lossless vs autoregressive quantized model: {lossless}")
    assert lossless
    return dict(lossless=lossless, L=quasar.mean_accept_len, steps=quasar.steps,
                vanilla_steps=vanilla.steps, params=params)


if __name__ == "__main__":
    main()
