"""Serving entry point: build a model with random weights and run batched generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --batch 4 --prompt-len 512 --new-tokens 32 --max-seq 1024

runs on the card; ``--reduced --device cpu`` runs the small variant on the
CPU.  Weights are drawn from ``--seed`` on the device (a checkpoint loader
is a later slice), prompts from the same seed with numpy, and for an
encoder-decoder (``--arch whisper-medium``) the encoder's frames after them
from the same stream, as the JAX launcher draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.serving.engine import Engine, ServeOptions


def build_engine(cfg, device, seed: int, options: ServeOptions) -> Engine:
    """An engine over weights of ``cfg.param_dtype`` drawn on ``device`` from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(T.model_skel(cfg), gen, dev, dtype_override=cfg.param_dtype)
    return Engine(cfg, params, options)


def random_batch(cfg, batch: int, prompt_len: int, seed: int):
    """Prompts (batch, prompt_len) int32 from ``RandomState(seed)``; for an
    encoder-decoder also ``encoder_frames`` (batch, encoder_seq, d_model)
    f32, drawn right after the prompts from the same stream."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = rng.randn(batch, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return out


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    eng = build_engine(cfg, dev, args.seed, ServeOptions(max_seq=args.max_seq, batch_size=args.batch))
    batch = random_batch(cfg, args.batch, args.prompt_len, args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = eng.generate(batch, args.new_tokens)  # ends in a copy to the host
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: generated {out.shape} tokens in {dt:.3f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s, prefill included)")
    print("first row:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
