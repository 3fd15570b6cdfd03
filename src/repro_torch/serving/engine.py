"""Serving engine: prefill + batched incremental decode (port of
``repro.serving.engine``), with greedy or temperature sampling and the
slot-based continuous-batching loop.

The engine runs where its parameters lie; there is no mesh on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeOptions:
    max_seq: int = 2048
    batch_size: int = 8
    temperature: float = 0.0


class Engine:
    def __init__(self, cfg: ModelConfig, params, options: ServeOptions):
        T.check_supported(cfg)
        self.cfg, self.params, self.options = cfg, params, options
        self.device = params["embed"].device
        # temperature sampling draws from this stream, fixed as JAX's PRNGKey(0)
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def prefill_fn(self, batch):
        return T.prefill(self.cfg, self.params, batch, cache_seq=self.options.max_seq)

    def decode_fn(self, token, t: int, caches):
        return T.decode_step(self.cfg, self.params, token, t, caches)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[..., : self.cfg.vocab_size]  # strip vocab padding
        if self.options.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.options.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    @torch.inference_mode()
    def generate(self, batch: Dict[str, object], num_steps: int) -> np.ndarray:
        """Prefill the prompts ``batch["tokens"]`` (B, S), then return the
        ``num_steps`` sampled tokens (B, num_steps) as int32.  The whole batch
        goes to prefill on the engine's device, as the JAX engine passes it:
        with M-RoPE the position streams, for an encoder-decoder the frames
        (which stay f32 until the encoder casts them).

        The JAX engine also runs a decode step after the last token and drops
        its result; this one stops at the last token it returns."""
        inputs = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        tokens = inputs["tokens"]
        prompt_len = tokens.shape[1]
        logits, caches = self.prefill_fn(inputs)
        tok = self._sample(logits)[:, None]
        out = []
        for i in range(num_steps):
            out.append(tok[:, 0])
            if i + 1 < num_steps:
                logits, caches = self.decode_fn(tok, prompt_len + i, caches)
                tok = self._sample(logits)[:, None]
        if not out:
            return np.zeros((tokens.shape[0], 0), np.int32)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# request-level continuous batching (for the serving example/bench)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchingLoop:
    """Slot-based continuous batching: a fixed decode batch whose finished
    slots are refilled from the queue (prefill per joining request)."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_iters: int = 1000):
        eng = self.engine
        B = eng.options.batch_size
        while self.queue and max_iters > 0:
            # take up to B requests; pad the slot dim to the fixed decode batch
            active = [self.queue.pop(0) for _ in range(min(B, len(self.queue)))]
            plen = max(len(r.prompt) for r in active)
            toks = np.zeros((B, plen), np.int32)
            for i, r in enumerate(active):
                toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
            steps = max(r.max_new for r in active)
            gen = eng.generate({"tokens": toks}, steps)
            for i, r in enumerate(active):
                r.output = list(gen[i, : r.max_new])
                r.done = True
                self.completed.append(r)
            max_iters -= 1
        return self.completed
