"""Deterministic synthetic token pipeline (port of ``repro.data.pipeline``).

Every (step, batch row) is a pure function of the seed: numpy's PCG64 keyed
as the JAX package keys it, so the port's batches are the JAX package's bit
for bit, and a run resumes by step index, not by iterator state.  A batch
lands on one device: whole, or the share of it that ``share`` picks from
the host batch (a pod's rows: ``launch.train.pod_share``).

``Prefetcher`` keeps a few batches ready in a background thread, so that
making them overlaps the device's step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _tokens_for(seed: int, step: int, row: int, seq: int, vocab: int, structured: bool = False) -> np.ndarray:
    """Deterministic per-row token generator (counter-based RNG).

    structured=True emits arithmetic sequences t[i+1] = (t[i] + d) % vocab
    with a per-row stride d in 1..8, inferable in context from the first two
    tokens, so a trained LM's loss can fall toward 0."""
    key = (seed * 0x9E3779B1 + step * 0x85EBCA77 + row * 0xC2B2AE3D) & 0xFFFFFFFF
    rng = np.random.Generator(np.random.PCG64(key))
    if structured:
        start = int(rng.integers(0, vocab))
        stride = int(rng.integers(1, 9))
        return ((start + stride * np.arange(seq, dtype=np.int64)) % vocab).astype(np.int32)
    return rng.integers(0, vocab, size=(seq,), dtype=np.int32)


def host_batch(cfg: ModelConfig, shape: ShapeSpec, step: int, seed: int = 0,
               structured: bool = False) -> Dict[str, np.ndarray]:
    """The global batch of ``step`` as numpy: tokens and next-token labels,
    (global_batch, seq_len) int32 each, and the M-RoPE positions or encoder
    frames of the configs that take them."""
    B, S = shape.global_batch, shape.seq_len
    toks = np.stack([_tokens_for(seed, step, r, S + 1, cfg.vocab_size, structured) for r in range(B)])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.rope == "mrope":
        batch["positions_3d"] = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    if cfg.is_encoder_decoder:
        rng = np.random.Generator(np.random.PCG64(seed * 7919 + step))
        batch["encoder_frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return batch


Share = Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]


def device_batch(cfg: ModelConfig, shape: ShapeSpec, step: int, device: torch.device, seed: int = 0,
                 structured: bool = False, share: Optional[Share] = None) -> Dict[str, torch.Tensor]:
    """``host_batch`` (or ``share`` of it) as tensors on ``device``.  For the
    card each array is copied from pinned host memory without blocking the
    host; the copy is ordered on the current stream before any work queued
    after it."""
    out = {}
    batch = host_batch(cfg, shape, step, seed, structured)
    for name, arr in (batch if share is None else share(batch)).items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[name] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


class Prefetcher:
    """Batches ``start_step``, ``start_step + 1``, ... (each ``share`` of the
    global batch, if given) made on a background thread, at most ``depth``
    ahead of the consumer.  Iterating yields
    ``(step, batch)``; ``close()`` stops the thread and drops what is queued.
    A failure in the thread is raised by the next ``next()``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, device: torch.device, start_step: int = 0,
                 seed: int = 0, depth: int = 2, share: Optional[Share] = None):
        self._args = (cfg, shape, device, seed, share)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(start_step,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, step: int) -> None:
        cfg, shape, device, seed, share = self._args
        while not self._stop.is_set():
            try:
                item = (step, device_batch(cfg, shape, step, device, seed, share=share), None)
            except Exception as e:  # handed to the consumer, which raises it
                self._put((step, None, e))
                return
            if not self._put(item):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                step, batch, err = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("prefetch thread ended without a batch")
        if err is not None:
            raise err
        return step, batch

    def close(self, timeout: Optional[float] = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
