"""Serving entry point: build a model with random weights and run batched generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --batch 4 --prompt-len 512 --new-tokens 32 --max-seq 1024

runs on the card; ``--reduced --device cpu`` runs the small variant on the
CPU.  Weights are drawn from ``--seed`` on the device (a checkpoint loader
is a later slice), prompts from the same seed with numpy, and for an
encoder-decoder (``--arch whisper-medium``) the encoder's frames after them
from the same stream, as the JAX launcher draws them.

``--devices 8`` serves on the debug mesh, (data 4, model 2), as the JAX
launcher does: 8 rank processes sharing the device (``core.group.run_ranks``
with the ``staged`` backend), the weights placed by
``partitioning.param_specs`` (rank 0 draws each one, from the stream one
process draws, and sends every rank its block), the engine over them
(``Engine(..., mesh=...)``).  With FSDP every decode step gathers the
weights.  ``--ckpt-dir`` serves the parameters of a train state's latest
checkpoint instead of drawing them, each rank reading its own blocks.  The
default, ``--devices 1``, is one process.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import group as G
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh, debug_mesh_shape, make_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.serving.engine import Engine, ServeOptions
from repro_torch.sharding import partitioning, placement
from repro_torch.train import step as TS

# Wall-clock seconds a run on a mesh may take.
MESH_TIMEOUT_S = 1800.0


def build_engine(cfg, device, seed: int, options: ServeOptions, mesh=None, ckpt_dir: Optional[str] = None) -> Engine:
    """An engine over weights of ``cfg.param_dtype`` drawn on ``device`` from
    ``seed`` (or the parameters of ``ckpt_dir``'s latest checkpoint), placed
    on ``mesh`` if given."""
    dev = resolve_device(device)
    if ckpt_dir:
        where = None
        if mesh is not None:
            where = placement.shardings(TS.state_specs(cfg, mesh, TS.TrainOptions(sharding=options.sharding)), mesh)
        _, state = Checkpointer(ckpt_dir).restore(TS.abstract_state(cfg), device=dev, placements=where)
        params = state["params"]
    elif mesh is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(T.model_skel(cfg), gen, dev, dtype_override=cfg.param_dtype)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        specs = partitioning.param_specs(cfg, T.model_skel(cfg), mesh, options.sharding)
        params = placement.init_params(T.model_skel(cfg), specs, mesh, gen, dev, cfg.param_dtype)
    return Engine(cfg, params, options, mesh=mesh)


def _generate(eng: Engine, batch, new_tokens: int, return_logits: bool):
    """``eng.generate``, asking for the logits only when wanted."""
    return eng.generate(batch, new_tokens, return_logits=True) if return_logits else eng.generate(batch, new_tokens)


def _serve_rank(dev, cfg, seed, options, batch, new_tokens, mesh_shape: AbstractMesh, ckpt_dir, return_logits):
    """One rank of ``serve`` on a mesh: rank 0's result, ``None`` elsewhere."""
    mesh = make_mesh(mesh_shape.shape, mesh_shape.mesh_dim_names, dev)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size()))
    eng = build_engine(cfg, dev, seed, options, mesh, ckpt_dir)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)  # generate's peak, not the placing's
    t0 = time.perf_counter()
    out = _generate(eng, batch, new_tokens, return_logits)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"out": out if dist.get_rank() == 0 else None, "seconds": dt, "peak_bytes": peak,
            "collectives": G.collective_counts(), "launches": ops.launch_counts()}


def serve(cfg, device, seed: int, options: ServeOptions, batch, new_tokens: int, devices: int = 1,
          ckpt_dir: Optional[str] = None, return_logits: bool = False):
    """``generate(batch, new_tokens)`` on one process, or with ``devices`` > 1
    on the debug mesh (``devices`` must be its size) as that many rank
    processes.  Returns (tokens, or tokens and logits with
    ``return_logits``; the seconds generate took; per rank, its seconds,
    peak device bytes, staged collectives and kernel launches, or ``None``
    on one process)."""
    dev = resolve_device(device)
    if devices == 1:
        eng = build_engine(cfg, dev, seed, options, ckpt_dir=ckpt_dir)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = _generate(eng, batch, new_tokens, return_logits)  # ends in a copy to the host
        return out, time.perf_counter() - t0, None
    shape = debug_mesh_shape()
    if devices != shape.size():
        raise ValueError(f"--devices {devices}: the debug mesh {shape.shape} has {shape.size()}")
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # once here, not in every rank at once
    ranks = G.run_ranks(_serve_rank, devices, dev, cfg, seed, options, batch, new_tokens, shape, ckpt_dir,
                        return_logits, timeout=MESH_TIMEOUT_S)
    return ranks[0]["out"], ranks[0]["seconds"], [{k: v for k, v in r.items() if k != "out"} for r in ranks]


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
    ap.add_argument("--devices", type=int, default=1,
                    help="rank processes sharing the device: 1, or the debug mesh's 8 (the JAX launcher's default)")
    ap.add_argument("--ckpt-dir", default=None, help="serve the parameters of this directory's latest checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    batch = random_batch(cfg, args.batch, args.prompt_len, args.seed)
    out, dt, _ = serve(cfg, dev, args.seed, ServeOptions(max_seq=args.max_seq, batch_size=args.batch), batch,
                       args.new_tokens, args.devices, args.ckpt_dir)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    on = f", mesh {debug_mesh_shape().shape} as {args.devices} rank processes" if args.devices > 1 else ""
    print(f"[serve] {cfg.name} on {where}{on}: generated {out.shape} tokens in {dt:.3f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s, prefill included)")
    print("first row:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
