"""Serving engine: prefill + batched incremental decode (port of
``repro.serving.engine``), with greedy or temperature sampling and the
slot-based continuous-batching loop.

The engine runs where its parameters lie.  Given a mesh (the JAX engine's
``mesh`` argument), the parameters are DTensors placed by
``partitioning.param_specs``; each prompt batch is placed by
``batch_specs`` and each decode token by ``token_batch_spec``, prefill lays
the caches out by ``cache_specs``, and the activations follow
``transformer.set_activation_sharding`` (the batch over the data axes that
divide it, the rest over the model axis), as the dry run's cells run.  The
sampled tokens are whole on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.sharding import partitioning, placement
from repro_torch.sharding.partitioning import ShardingOptions


@dataclasses.dataclass
class ServeOptions:
    max_seq: int = 2048
    batch_size: int = 8
    temperature: float = 0.0
    sharding: ShardingOptions = dataclasses.field(default_factory=ShardingOptions)


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


class Engine:
    def __init__(self, cfg: ModelConfig, params, options: ServeOptions, mesh=None):
        T.check_supported(cfg)
        self.cfg, self.params, self.options, self.mesh = cfg, params, options, mesh
        embed = params["embed"]
        self.device = embed.to_local().device if isinstance(embed, DTensor) else embed.device
        if mesh is not None:
            placement.check_tree_on(params, self.device)
        # temperature sampling draws from this stream, fixed as JAX's PRNGKey(0)
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def prefill_fn(self, batch):
        return T.prefill(self.cfg, self.params, batch, cache_seq=self.options.max_seq)

    def decode_fn(self, token, t: int, caches):
        return T.decode_step(self.cfg, self.params, token, t, caches)

    def _placed(self, arr, spec) -> torch.Tensor:
        """``arr`` (whole, the same on every rank) as a DTensor by ``spec``."""
        t = torch.as_tensor(arr)
        like = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return placement.place(like, spec, self.mesh, lambda block: t[block].to(self.device), source="block")

    def _inputs(self, batch) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        B, S = tuple(batch["tokens"].shape)
        specs = partitioning.batch_specs(self.cfg, self.mesh, ShapeSpec("serve", S, B, "prefill"),
                                         self.options.sharding)
        return {k: self._placed(v, specs[k]) for k, v in batch.items()}

    def _token(self, tok: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return tok
        return self._placed(tok, partitioning.token_batch_spec(self.mesh, tok.shape[0], self.options.sharding))

    @contextlib.contextmanager
    def _program(self, batch: int):
        """No autograd; on a mesh, the activations' policy for ``batch`` rows
        and DTensor's ``implicit_replication``, as the dry run runs prefill
        and decode (and ``no_grad``: a DTensor's view of an inference tensor
        is refused)."""
        if self.mesh is None:
            with torch.inference_mode():
                yield
            return
        prev = dict(T.ACTIVATION_SHARDING)
        T.set_activation_sharding(partitioning._batch_axes(self.mesh, batch, self.options.sharding),
                                  self.options.sharding.tp_axis)
        try:
            with torch.no_grad(), implicit_replication():
                yield
        finally:
            T.ACTIVATION_SHARDING.update(prev)

    def forward(self, batch) -> torch.Tensor:
        """``transformer.forward``'s logits over the whole batch, f32, whole
        on every rank (the full-sequence path that prefill and decode must
        agree with)."""
        with self._program(tuple(batch["tokens"].shape)[0]):
            return _whole(T.forward(self.cfg, self.params, self._inputs(batch))[0])

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = _whole(logits)[..., : self.cfg.vocab_size]  # strip vocab padding
        if self.options.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.options.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(self, batch: Dict[str, object], num_steps: int, return_logits: bool = False):
        """Prefill the prompts ``batch["tokens"]`` (B, S), then return the
        ``num_steps`` sampled tokens (B, num_steps) as int32.  The whole batch
        goes to prefill on the engine's device, as the JAX engine passes it:
        with M-RoPE the position streams, for an encoder-decoder the frames
        (which stay f32 until the encoder casts them).  With
        ``return_logits``, also the f32 logits each token was sampled from,
        (B, num_steps, vocab), as numpy.

        The JAX engine also runs a decode step after the last token and drops
        its result; this one stops at the last token it returns."""
        B, prompt_len = tuple(batch["tokens"].shape)
        with self._program(B):
            logits, caches = self.prefill_fn(self._inputs(batch))
            seen = []
            tok = self._sample(logits)[:, None]
            out = []
            for i in range(num_steps):
                out.append(tok[:, 0])
                if return_logits:
                    seen.append(_whole(logits)[:, : self.cfg.vocab_size].float().cpu())
                if i + 1 < num_steps:
                    logits, caches = self.decode_fn(self._token(tok), prompt_len + i, caches)
                    tok = self._sample(logits)[:, None]
        toks = (torch.stack(out, dim=1).cpu().numpy().astype(np.int32) if out
                else np.zeros((B, 0), np.int32))
        if return_logits:
            seen = (torch.stack(seen, dim=1).numpy() if seen
                    else np.zeros((B, 0, self.cfg.vocab_size), np.float32))
            return toks, seen
        return toks


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
