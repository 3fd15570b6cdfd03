#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds each against its plain PyTorch version at the main paths'
shapes and the sweeps of tests/test_kernels.py (flash attention's output and
log-sum-exp on both routes, bf16 and f32, at every head dim, its
autograd backward against the CPU's, and the flash at every serve run's
prefill shape; ``chunk_reduce`` in f32, bf16 and f16), times RMSNorm against
``F.rms_norm``, the flash forward at the serve, train and prefill shapes
against SDPA (with a window as a boolean mask), ``chunk_reduce`` at the
sync's hop and in f16 at the data plane's fold windows against
``torch.add``, then drives these paths (``--only a,b`` drives the named
ones alone):

- dataplane: Hoplite's data plane (``core/local.LocalCluster``, 8 nodes
  whose stores lie on the card, inproc): at the paper's object sizes (1 KB,
  32 KB, 1 MB, 32 MB, 1 GiB) a broadcast from node 0 to the other 7, a
  reduce of one object a node and an allreduce, in f32 with integer-valued
  data, each exact; a random f32 reduce at 32 MB against an f64 sum; bf16
  and f16 reduces at 32 MB with every fold window's ``chunk_reduce`` held
  bit for bit to its plain version on that window; at 1 GiB a paced chain
  whose tail is killed past half the target's watermark, which must
  re-splice and stay exact; the socket backend's broadcast and reduce at 32
  MB on 4 nodes.  Each operation prints its wall ms, GB/s, windows, peak
  memory and the SUM folds the cluster counted against the change in
  ``chunk_reduce``'s launches, which must be equal.
- asgd: the asynchronous parameter server
  (``repro_torch.examples.async_parameter_server``) at the JAX example's
  defaults (its losses must fall below 0.7 of the first), then on 8 nodes
  and 8 workers at 25,557,032 parameters (102.2 MB objects, ResNet-50's
  count), 16 samples a shard drawn on the card, the first 4 finishers
  reduced each round, 12 rounds and a node killed after round 6: the loss
  must fall below 0.7 of the first with at least one task re-executed.
- serve_ensemble: Hoplite-Serve (``repro_torch.serve``) over the task
  runtime, at the sizes of the JAX package's ensemble scenario
  (``core/simulation.ensemble_serving``'s and ``EnsembleConfig``'s
  defaults): ``Runtime(num_nodes=8, executors_per_node=4)`` on the card, 8
  replicas and a quorum of 5, 64 MB f32 weights W (4096 x 4096, drawn from
  the seed), 256 KB payloads x of (16, 4096) and replies x @ W.  40 requests
  arrive open loop at 40 rps through ``OpenLoopRouter``; the node of
  replica 7 is killed at request 10, a second seeded W is published
  mid-stream at request 20 and a replica is added at request 30 (its
  weights staged through the broadcast tree).  Every completed value must
  lie within the rounding bound of the f64 mean of its replies under one
  version (never a mix), completed + rejected + failed = offered with no
  failure, the stores and the runtime's tables hold no more of the
  requests' objects than before the stream, and the SUM folds the cluster
  and the lineage fallback counted must equal ``chunk_reduce``'s launches,
  at least k - 1 a completed request.  It prints the latency's p50, p99
  and max, each version's deploy time, the throughput, the launches and
  ``max_memory_allocated``.

- serve: qwen3-14b at full width (40 layers, d=5120, bf16 weights drawn on
  the card from seed 0), 4 prompts of 512 tokens, 32 greedy tokens each, with
  a max_seq of 1024.  It checks that the serve run launched the kernels, that
  the tokens and logits are sane, and that decode agrees with prefill, then
  times prefill and decode and profiles one of each (kernel busy time).
- serve_f32: the same model at full width in f32 (the config's ``dtype`` and
  ``param_dtype`` set to float32), cut to 8 of 40 layers (16.8 GB of f32
  weights), 4 prompts of 512 tokens and 8 greedy tokens with a max_seq of
  1024: every prefill's flash runs on the f32 kernel (three TF32 products),
  at the shape its kernel record is timed at.  The same checks and times as
  serve; none of its flash launches writes the lse.
- serve_moe: the MoE family at full width, its depth cut (the whole models
  do not fit one card): mixtral-8x22b (8 experts top-2, sliding window 4096)
  cut to 8 of 56 layers, 2 prompts of 4608 tokens and 32 greedy tokens with a
  max_seq of 8192, so that its caches are rings of 4096 slots, prefill takes
  the ring's roll and every decode step wraps; and llama4-scout-17b-a16e (16
  experts top-1 and a shared expert) cut to 2 of 48 layers, 4 prompts of 512
  tokens and 8 greedy tokens.  The same checks and times as serve.  Before
  them it holds the windowed flash at mixtral's prefill shape to the plain
  version (and times it against SDPA with the window as a boolean mask), and
  one full-width mixtral MoE layer's dropping dispatch, with room for every
  token, to the dense one.
- serve_dense: the rest of the dense-attention family at full width, with
  the same checks and times as serve: gemma3-27b (all 62 layers, 5:1
  local:global windows of 1024, qk-norm, the gelu FFN), 2 prompts of 1536
  tokens and 16 greedy tokens with a max_seq of 2048, so that prefill rolls
  the local rings and every decode step wraps them; starcoder2-3b (LayerNorm,
  the gelu FFN, 2 kv heads) and stablelm-3b (LayerNorm, 32 kv heads, head dim
  80, padded to 128 in the tensor-core kernel's shared memory), 4 prompts of
  512 tokens and 32 greedy tokens; qwen2-vl-72b (M-RoPE) cut to 16 of 80
  layers, 4 prompts of 512 tokens and 8 greedy tokens.  The kernel phase
  holds the flash forward at each run's prefill shape to the plain version
  and times it against SDPA.
- serve_ssm: the SSM families at full width, with the same checks and times
  as serve: rwkv6-1.6b at all 24 layers (RWKV-6 blocks, LayerNorm: no kernel
  of the port), and jamba-v0.1-52b cut to one period of 8 of its 32 layers
  (one attention layer without rotary embedding, seven Mamba layers, the
  16-expert MoE on four), 4 prompts of 512 tokens, 32 and 16 greedy tokens.
  The cache check holds the state caches (conv, SSM, shift, wkv).  Then the
  scans, which are plain PyTorch loops over time: one layer's scan alone at
  the prefill shape (time, device busy time, device events), and the share
  of a prefill and of a decode step that the scans take.  The kernel phase
  holds the flash at jamba's prefill shape (G = 4, no RoPE) and RMSNorm at
  its rows.
- serve_encdec: the encoder-decoder whisper-medium whole at full width (24
  encoder layers over 1500 frames a row, 24 decoder layers with
  cross-attention, d=1024, 16 heads of 64, LayerNorm, the gelu FFN,
  sinusoidal positions), 4 prompts of 384 tokens with their frames drawn
  after them from seed 0 (``launch.serve.random_batch``), 32 greedy tokens
  with a max_seq of 448, whisper's text context.  The same checks and times
  as serve, the frames given to every prefill; the encoder's time and its
  share of a prefill, and the cross caches' bytes.  The flash runs
  bidirectional (the encoder, and cross-attention with Sq != Skv, neither a
  multiple of the 128-row tile), and the kernel phase holds it at the
  encoder, decoder and cross shapes of this run.
- sync: the train step's cross-pod gradient sync (``launch/sync.py``) on 4
  rank processes that share the card, over the bf16 gradient tree of one
  full-width qwen3-14b decoder block per rank, by every method.  Each rank
  checks its hop-kernel launches against the schedules' prediction and its
  result against the seeded mean; the chain methods' ranks must agree bit
  for bit.  Ranks 0 and 1 also measure the host-staged link, and all ranks
  measure it once more under load, exchanging around the ring at once.
- train: ``launch.train.run`` on qwen3-14b at full width with its depth cut
  to 4 layers (40 layers of weights, AdamW moments and f32 gradient sums do
  not fit one card), bf16, at train_4k's sequence of 4096 tokens, a global
  batch of 2 in 2 microbatches, full remat, AdamW as configured, 3 steps.
  First it holds the loss and every gradient of the path, at full width cut
  to one layer and one microbatch, to plain f32 autograd with no kernel
  (``check_train_gradients``).  It checks the losses and gradient norms, the
  first loss against ln(vocab), and the kernel launches per step against
  ``expected_train_launches``, and profiles one more step.
- dryrun: the port's dry run (``launch.dryrun.trace_cell``: ``MemTracker``
  and ``launch.op_cost`` under ``FakeTensorMode``) over the train phase's own
  step, as fake tensors on the ``cuda`` device with no mesh: its predicted
  peak must lie within 10% of the train phase's ``max_memory_allocated``.  It
  prints the step's traced FLOPs, their share of the 989 TFLOP/s bf16 peak at
  the measured median step time beside 6 * N * tokens, and the host cost a
  call of the custom ops (``repro_torch::rmsnorm`` at a decode step's rows,
  the flash forward) against the kernel wrappers they call.  It writes
  nothing and launches nothing in the trace.
- ckpt: checkpoint and restart of the same train state (28.77 GB: bf16
  parameters, f32 AdamW moments, the counts).  It prints the free disk and
  host memory first and fails if they cannot hold one checkpoint and two
  host copies.  ``launch.train.run`` takes CKPT_SAVE_AT steps; the state is
  saved asynchronously into a directory under ``build/`` (the only
  checkpoint of this size the run writes, so that the whole run writes
  about 29 GB to disk), and the uninterrupted run steps on for as long as
  the write lasts, then CKPT_AFTER steps more (the copy to host memory's
  time, the write's time and rate, the median and largest step time before,
  during and after the write); then its state is freed.  The checkpoint is
  restored onto the card (time and rate) and must equal the state as saved
  bit for bit; from it CKPT_RESUMED steps run again: the first loss must
  equal the uninterrupted one bit for bit, the later losses and gradient
  norms lie within CKPT_RTOL.  Then ``launch.train`` restarts
  from a checkpoint directory on the card on reduced qwen3-14b in bf16, bit
  for bit against an uninterrupted run.  The directory is removed at the
  end whatever happens.
- pods: the launcher's multi-pod training (``launch.train.run(pods=2)``,
  ``--multi-pod --pod-sync hoplite_chain``) on qwen3-14b at full width cut to
  one layer: 2 pods, each a rank process with its own replica of the state
  (18.86 GB) on the one card, one row of 4096 tokens a pod (its share of a
  global batch of 2 by ``batch_specs``' placements), 3 steps; every hop of
  the gradient sync between the pods (3.77 GB of bf16 gradients a step) is
  the ``chunk_reduce`` kernel.  It reckons the memory the two replicas need
  first and fails if the card cannot hold them.  One process takes the first
  step on the joined batch before the pods start, and is freed.  The pods'
  replicas must hash the same after every step, their first loss and
  gradient norm equal the one process's within POD_RTOL, and each pod's
  launches per step are predicted (``expected_pod_launches``).  Each step's
  time is split into the pod's own step and the sync, beside the sync's
  time predicted from ``core.planner.HOST_STAGED_LINK``.
- mesh: the launchers over the debug mesh as ``--devices 8``: 8 rank
  processes share the card and meet in the ``staged`` process group (every
  collective through pinned host buffers and gloo).  Train
  (``launch.train.run(mesh=...)``, 4 x 2048 tokens in 2 microbatches, full
  remat, 2 steps) on qwen3-14b's layer widths with its vocabulary cut to
  32,768: at 151,936 the embedding, split over the model axis only, holds
  3.89 GB of weights and f32 moments a rank, and 8 ranks run out of the card
  even at 1 layer in 1 microbatch (``chip_mesh_fit.py``).  2 layers on (data
  4, model 2); 2 layers on (pod 2, data 2, model 2) under ``hoplite_chain``
  (the hop kernel on each rank's local blocks, the pods' blocks bit for bit
  the same) and ``gspmd``; sampled parameters' updates held against one
  process's.  Serve
  (``launch.serve.serve(devices=8)``) qwen3-14b at full width cut to 4
  layers, 4 x 512 tokens and 4 greedy tokens (the training on (data 4,
  model 2) ran 4 layers before the dataplane and asgd phases came).  Each
  rank's launches are
  predicted, its ``max_memory_allocated`` held within 10% of the dry run's
  per-device prediction (fake ``cuda`` tensors on a fake mesh), and the
  metrics, logits and first tokens against one process's on the card; the
  step time is printed beside the staged collectives' calls, bytes and
  seconds.

Every phase raises on failure; the script then exits non-zero.  At the end
it stops multiprocessing's resource tracker (started by the sync, pods and
mesh phases' ranks) and fails if any process it started is still there.

The last two lines are a JSON ``kernels`` record (times, bounds, launches)
and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# "float32" is the CUDA cores', "tf32" the tensor cores' rate in TF32.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
# The f32 flash kernel runs each of its products as this many TF32 products
# on the tensor cores (csrc/flash_attention.cu): its bound counts them all.
F32_FLASH_PRODUCTS = 3

# Cycles the card spins before each timed run (about 0.1 ms), longer than the
# host takes to enqueue any one kernel here.
SPIN_CYCLES = 200_000
# Bytes the L2 flush before each timed run reads: five times the H100's 50 MB
# L2, so that none of the timed kernel's operands is left in it.
FLUSH_BYTES = 256 << 20

# tests/test_kernels.py:16-17, used as both rtol and atol; the log-sum-exp
# (f32 from either type) is held to the same numbers, absolute
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL["float16"] = 1e-3  # f16's 10-bit mantissa; chunk_reduce is held bit for bit anyway

FLASH_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window): tests/test_kernels.py:24-32
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 4, 1, 256, 256, 32, True, 0),
    (1, 2, 2, 128, 128, 64, False, 0),
    (1, 2, 2, 256, 256, 64, True, 64),
    (1, 2, 1, 64, 512, 64, True, 0),
    # bidirectional with Sq != Skv, neither a multiple of the 128-row tile: a
    # cross-attention's shape (whisper's kv edge tile of 1500 = 11 x 128 + 92)
    (2, 4, 4, 200, 1500, 64, False, 0),
]

ARCH, BATCH, PROMPT, NEW_TOKENS, MAX_SEQ, SEED = "qwen3-14b", 4, 512, 32, 1024, 0

# The serve_moe phase, per arch: (layers kept, batch, prompt, greedy tokens, max_seq).
MOE_RUNS = {"mixtral-8x22b": (8, 2, 4608, 32, 8192), "llama4-scout-17b-a16e": (2, 4, 512, 8, 1024)}

# The serve_dense phase, per arch: (layers kept, batch, prompt, greedy tokens,
# max_seq).  qwen2-vl-72b's 80 layers are 145 GB of bf16 weights.
DENSE_RUNS = {"gemma3-27b": (62, 2, 1536, 16, 2048), "starcoder2-3b": (30, 4, 512, 32, 1024),
              "stablelm-3b": (32, 4, 512, 32, 1024), "qwen2-vl-72b": (16, 4, 512, 8, 1024)}
# The serve_ssm phase, per arch: (layers kept, batch, prompt, greedy tokens,
# max_seq).  jamba's 32 layers are 99 GB of bf16 weights; 8 are one period of
# its pattern (attention, seven Mamba layers, MoE on every second).
SSM_RUNS = {"rwkv6-1.6b": (24, 4, 512, 32, 1024), "jamba-v0.1-52b": (8, 4, 512, 16, 1024)}
# The serve_encdec phase, per arch: (layers kept, batch, prompt, greedy tokens,
# max_seq).  whisper-medium whole: 24 encoder and 24 decoder layers over the
# config's 1500 frames a row; 448 is its published text context.
ENCDEC_RUNS = {"whisper-medium": (24, 4, 384, 32, 448)}
SERVE_RUNS = {**MOE_RUNS, **DENSE_RUNS, **SSM_RUNS, **ENCDEC_RUNS}
# The flash forward at the prefill shapes of serve_moe, serve_dense,
# serve_ssm and serve_encdec (the run's batch, every head, bf16), per (arch,
# the layers' attention): "full" and "window" are the decoder's causal
# self-attention over the prompt, "encoder" the encoder's bidirectional
# self-attention over the frames, "cross" the prompt against the frames.
# Every one on the tensor cores (head dim 128, stablelm's 80, whisper's 64).
FLASH_PREFILL = (("mixtral-8x22b", "window"), ("stablelm-3b", "full"), ("gemma3-27b", "window"),
                 ("gemma3-27b", "full"), ("starcoder2-3b", "full"), ("qwen2-vl-72b", "full"),
                 ("jamba-v0.1-52b", "full"), ("whisper-medium", "encoder"), ("whisper-medium", "full"),
                 ("whisper-medium", "cross"))
# One full-width mixtral MoE layer's two dispatches on this many tokens (B, S).
MOE_LAYER_TOKENS = (2, 512)
# The dropping dispatch with room for every token against the dense one, bf16:
# max abs error over the dense output's largest magnitude.
MOE_DISPATCH_TOL = 2e-2

# The serve_f32 phase: qwen3-14b at full width in f32, its depth cut to
# F32_LAYERS (16.8 GB of f32 weights), BATCH prompts of PROMPT tokens,
# F32_NEW_TOKENS greedy tokens, MAX_SEQ.
F32_LAYERS, F32_NEW_TOKENS = 8, 8

# The train phase: qwen3-14b's widths, its depth cut to TRAIN_LAYERS, train_4k's
# sequence, TRAIN_BATCH rows in TRAIN_MICRO microbatches, TRAIN_STEPS steps.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 2, 2, 3
# The flash forward at the train shape: one row of the batch, every head.
FLASH_TRAIN = (1, 40, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, 0)
# bf16 at head dim 256, which no config has (Gemma's heads are that wide): the
# tensor-core kernel's widest instance (four 64-column boxes, kv tiles of 64
# rows, one Q buffer), held and timed in the kernel phase.
WIDE_BF16 = (BATCH, 16, 8, PROMPT, PROMPT, 256, True, 0)

# The ckpt phase: the state is saved after step CKPT_SAVE_AT (steps 2 to
# CKPT_SAVE_AT time the step before the write); the uninterrupted run steps
# while the write lasts (at most CKPT_MAX_DURING steps), then CKPT_AFTER more;
# the run resumed from the checkpoint takes CKPT_RESUMED steps.
CKPT_SAVE_AT, CKPT_MAX_DURING, CKPT_AFTER, CKPT_RESUMED = 4, 200, 3, 2
# The resumed run's steps after its first against the uninterrupted ones,
# relative (see ckpt).
CKPT_RTOL = 1e-3
# Room on top of the checkpoint on disk and of the host copies in memory.
CKPT_SPARE_BYTES = 4e9

# The sync phase: rank processes on the one card (each with one decoder
# block of gradients)
SYNC_RANKS = 4

# The pods phase: qwen3-14b's widths cut to POD_LAYERS, POD_PODS pods (each a
# rank process with a replica) on the one card, a global batch of POD_BATCH
# rows of train_4k's sequence (one row a pod, one microbatch), POD_STEPS steps.
POD_LAYERS, POD_PODS, POD_BATCH, POD_STEPS = 1, 2, 2, 3
# The pods' first step against one process on the joined batch, relative
# (tests/test_torch_train.py::test_pod_step_matches_one_process_on_the_joined_batch).
POD_RTOL = 1e-5

# Names of the port's kernels in a profile (see device_profile).
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_f32_kernel", "rmsnorm", "chunk_reduce_kernel")
# Kinds of device events in a profile, by a piece of their names; the first that matches wins.
EVENT_KINDS = (("the port's kernels", PORT_KERNELS), ("LayerNorm", ("layer_norm",)), ("GELU", ("gelu",)),
               ("f32 GEMMs", ("f32f32",)),
               ("other GEMMs", ("gemm", "nvjet", "xmma", "cutlass")), ("elementwise", ("elementwise",)),
               ("reductions", ("reduce",)), ("copies and fills", ("Memcpy", "Memset", "copy", "fill")))

# Decode versus prefill of the longer prompt, in bf16 (see check_cache).
CACHE_REL_L2_TOL = 5e-2
# The routing rule (see check_cache): a token may route differently only
# where its k-th and (k+1)-th router logits lie this close, over its largest
# router-logit magnitude.
ROUTE_MARGIN = 2e-2
# Rows of the cache check (the serve batch, and more prompts from the same
# seed where the batch is smaller).
CACHE_ROWS = 4

# The train path's bf16 gradients against plain f32 autograd, relative L2 per
# leaf (see check_train_gradients): on the CPU each package's bf16 gradients of
# the reduced model lie 0.8-2.5% from its f32 ones (tests/test_torch_train.py).
GRAD_REL_L2_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events.  Each
    run follows a flush of the L2 that only reads (a sum of FLUSH_BYTES into
    one scalar) and a spin of the card (``torch.cuda._sleep``) that keeps it
    busy while the host enqueues ``fn``, so the host's launch overhead
    (Python, ctypes, the tensor maps) is not counted: the events bracket the
    device's work.  The read evicts ``fn``'s operands and writes back every
    dirty line that earlier work left in the L2 before the window opens, so
    the window holds ``fn``'s own traffic and no other kernel's write-back
    (a flush that writes leaves the L2 full of dirty lines, and the timed
    kernel's reads evict them inside its window)."""
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.sum(flush, 0, out=total)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, what: str, got, want, dtype: str) -> float:
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    log(f"[kernels] {what}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok or got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max_abs_err {err})")
    return err


def serve_rmsnorm_rows(cfg, batch: int, prompt: int):
    """The (rows, d) shapes that serving ``cfg`` gives RMSNorm, in prefill and
    in a decode step: ln1, ln2 and the final norm at d_model (none where
    ``cfg.norm`` is LayerNorm), and with qk-norm q's and k's heads."""
    shapes = []
    for tokens in (batch * prompt, batch):
        if cfg.norm == "rmsnorm":
            shapes.append((tokens, cfg.d_model))
        if cfg.qk_norm:
            shapes += [(tokens * cfg.num_heads, cfg.head_dim), (tokens * cfg.num_kv_heads, cfg.head_dim)]
    return shapes


def check_rmsnorm(torch, rn, ref, gen):
    """Kernel against plain version at every shape the serve paths give it
    (``serve_rmsnorm_rows`` of qwen3 and of each run of SERVE_RUNS)
    and the train path's (a microbatch is one row of TRAIN_SEQ tokens: ln1,
    ln2 and the final norm, the qk-norm of q's 40 heads and k's 8), in bf16
    and f32; at the serve path's first two shapes also a view of x 2 or 4
    bytes past a 16-byte boundary (the kernel's scalar path), and at its
    first three rows normed alone against the batch, bit for bit.  Returns
    the record at the serve path's shape."""
    from repro_torch.configs import get_config

    shapes = serve_rmsnorm_rows(get_config(ARCH), BATCH, PROMPT) + [
        (5, 16383), (TRAIN_SEQ, 5120), (TRAIN_SEQ * 40, 128), (TRAIN_SEQ * 8, 128)]
    for arch, (_, batch, prompt, _, _) in SERVE_RUNS.items():
        shapes += serve_rmsnorm_rows(get_config(arch), batch, prompt)
    shapes = list(dict.fromkeys(shapes))
    path_err = None
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            w = (torch.randn(shape[-1], generator=gen, device="cuda") * 0.1).to(dt)
            got = rn.rmsnorm(x, w)
            err = compare(torch, f"rmsnorm {shape} {dtype}", got, ref.rmsnorm_ref(x, w), dtype)
            if shape == shapes[0] and dtype == "bfloat16":
                path_err = err
            if shape in shapes[:3]:  # the serve path's widths: d_model and the qk-norm's heads
                check_rmsnorm_rows_alone(torch, rn, x, w, got, f"{shape} {dtype}")
        for shape in shapes[:2]:  # a view 2 or 4 bytes past a 16-byte boundary: the scalar path
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            w = (torch.randn(shape[-1], generator=gen, device="cuda") * 0.1).to(dt)
            flat = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
            xv = flat[1:].view(shape)
            xv.copy_(x)
            compare(torch, f"rmsnorm {shape} {dtype}, x {xv.data_ptr() % 16} bytes past 16", rn.rmsnorm(xv, w),
                    ref.rmsnorm_ref(x, w), dtype)
    torch.cuda.synchronize()
    spread = {str(shape): rmsnorm_vs_library(torch, rn, gen, shape) for shape in shapes[:2]}
    x = torch.randn(shapes[0], generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(5120, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    plain = time_ms(torch, lambda: ref.rmsnorm_ref(x, w))
    path = spread[str(shapes[0])]
    b_ms, b_by = bound(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), "bfloat16")
    log(f"[kernels] rmsnorm {tuple(x.shape)} bf16: kernel {path['kernel_ms']:.4f} ms, plain {plain:.4f} ms, "
        f"F.rms_norm {path['library_ms']:.4f} ms (medians), bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:25", "shape": f"x {tuple(x.shape)} bf16",
        "max_abs_err": path_err, "ms": path["kernel_ms"], "kernel_ms": path["kernel_ms"], "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": path["library_ms"], "against_library": spread,
    }


def check_rmsnorm_rows_alone(torch, rn, x, w, batch, what: str):
    """Rows normed alone (one, four, and the last) equal the same rows of
    ``batch``, which normed all of ``x`` at once, bit for bit: a decode step
    norms one token's rows where prefill normed them together."""
    for rows in (slice(0, 1), slice(5, 9), slice(x.shape[0] - 1, None)):
        if not torch.equal(rn.rmsnorm(x[rows].clone(), w), batch[rows]):
            raise AssertionError(f"rmsnorm {what}: rows {rows.start}-{x.shape[0] if rows.stop is None else rows.stop} "
                                 "normed alone differ from the batch's")
    log(f"[kernels] rmsnorm {what}: rows normed alone equal the batch's, bit for bit")


def rmsnorm_vs_library(torch, rn, gen, shape, reps: int = 5):
    """The kernel and ``F.rms_norm`` (which takes the whole scale, 1 + w) on
    the same bf16 x, timed in turns, ``reps`` runs of ``time_ms`` each: the
    median and range of each and the ratio of the medians."""
    d = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    w1 = 1.0 + w
    ks, ls = [], []
    for _ in range(reps):
        ks.append(time_ms(torch, lambda: rn.rmsnorm(x, w)))
        ls.append(time_ms(torch, lambda: torch.nn.functional.rms_norm(x, (d,), w1, 1e-6)))
    k, lib = statistics.median(ks), statistics.median(ls)
    b_ms, b_by = bound(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), "bfloat16")
    log(f"[kernels] rmsnorm {shape} bf16 against F.rms_norm, {reps} turns of time_ms: kernel median {k:.6f} ms "
        f"(range {min(ks):.6f}-{max(ks):.6f}), F.rms_norm median {lib:.6f} ms (range {min(ls):.6f}-{max(ls):.6f}), "
        f"ratio of medians {k / lib:.4f} (per turn {min(a / b for a, b in zip(ks, ls)):.4f}-"
        f"{max(a / b for a, b in zip(ks, ls)):.4f}); bound {b_ms:.4f} ms ({b_by}), kernel at {100 * b_ms / k:.1f}% "
        f"of it, F.rms_norm at {100 * b_ms / lib:.1f}%")
    return {"kernel_ms": k, "kernel_range": [min(ks), max(ks)], "library_ms": lib,
            "library_range": [min(ls), max(ls)], "ratio": k / lib, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / k, "library_share_of_bound": b_ms / lib}


def flash_pairs(torch, Sq, Skv, causal, window, q_offset) -> int:
    """(query, key) pairs the masks leave visible: the work these inputs need."""
    qpos = q_offset + torch.arange(Sq)
    kpos = torch.arange(Skv)
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return int(mask.sum())


def spill_bytes(report: str) -> int:
    """The most spill bytes (stores or loads) of any kernel in an nvcc report."""
    return max([int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", report)] or [0])


def flash_instances(report: str, kernel: str = "flash_fwd_sm90_kernel") -> dict:
    """Registers, stack frame and spill bytes of each head dim's instance of
    a flash kernel (the bf16 one, ``flash_fwd_sm90_kernel``, or the f32 one,
    ``flash_fwd_f32_kernel``), from its nvcc report (``-Xptxas -v``).  The
    registers are the launch's; the bf16 kernel's consumers raise theirs to
    240 with setmaxnreg.  Shared memory is dynamic (each instance's Layout)
    and the report does not show it."""
    out, d = {}, None
    for line in report.splitlines():
        m = re.search(kernel + r"ILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            d = int(m.group(1))
            out[d] = {}
        elif d is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[d].update(stack_bytes=int(m.group(1)), spill_bytes=max(int(m.group(2)), int(m.group(3))))
        elif d is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[d]["registers"] = int(m.group(1))
            d = None
    return dict(sorted(out.items()))


def flash_inputs(torch, gen, B, H, Kh, Sq, Skv, D, dt):
    """q of std 2 and k, v of std 1: the scaled scores q.k / sqrt(D) have a
    std of 2 (the qk-normed serve path's are near 1), so the softmax is far
    from uniform and the output depends on every score."""
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda") * 2
    k = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda")
    v = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda")
    return q.to(dt), k.to(dt), v.to(dt)


def check_sensitive(torch, ref, what, got, q, k, v, causal, window, q_offset, dtype: str = "bfloat16"):
    """The check of ``dtype`` (2e-2 in bf16, 2e-5 in f32) must fail an
    output that a wrong Q.K^T would give: the plain version with K's columns
    rolled by one 16-byte unit (8 bf16 or 4 f32 columns, as a wrong swizzle
    or descriptor would read them) and with S = 0 (K zeroed)."""
    cols = 16 // k.element_size()
    for wrong, kk in ((f"K's columns rolled by {cols}", k.roll(cols, dims=-1)), ("S = 0", torch.zeros_like(k))):
        bad = ref.flash_attention_ref(q, kk, v, causal, window, q_offset)
        if torch.allclose(got.float(), bad.float(), rtol=TOL[dtype], atol=TOL[dtype]):
            raise AssertionError(f"{what}: the {dtype} check cannot tell the output from {wrong}")


def check_flash(torch, fa, ref, gen, spills: dict, instances: dict):
    """Both routes against the plain version, output and lse: at the serve
    shape, its 513-token variant, a window whose first rows see no key, the
    sweeps of tests/test_kernels.py and every head dim of ``fa.TC_HEAD_DIMS``
    (every multiple of 16 up to 256) at a ragged shape with Sq != Skv, in
    bf16 (and WIDE_BF16) on the bf16 kernel and in f32 on the f32 kernel.  On
    every case the check is also shown to fail a wrong Q.K^T.  Then both
    routes at FLASH_TRAIN's shape.  Times the bf16 route at the serve shape,
    WIDE_BF16 and the train shape, and the f32 route at the serve shape and
    at the train shape with its lse (``time_flash_f32``).  ``spills`` and
    ``instances`` are each kernel's, by route.  Returns the records of the
    two routes."""
    cfg_case = (BATCH, 40, 8, PROMPT, PROMPT, 128, True, 0)
    ragged = (BATCH, 40, 8, PROMPT + 1, PROMPT + 1, 128, True, 0)  # prefill of prompt + token
    window = (1, 2, 1, 200, 200, 64, True, 16)  # with q_offset -20: the first rows see no key
    sweep = [(2, 4, 2, 200, 300, D, True, 0) for D in fa.TC_HEAD_DIMS]  # q_offset 100
    errs, lse_errs = {}, {}

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        extra = sweep + [WIDE_BF16] if dtype == "bfloat16" else sweep
        for case in [cfg_case, ragged, window] + FLASH_CASES + extra:
            B, H, Kh, Sq, Skv, D, causal, win = case
            q, k, v = flash_inputs(torch, gen, B, H, Kh, Sq, Skv, D, dt)
            off = -20 if case == window else Skv - Sq
            before = fa.launches_tc, fa.launches_f32
            got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win, q_offset=off)
            route = fa.route(dt, D)
            if (fa.launches_tc - before[0], fa.launches_f32 - before[1]) != ((1, 0) if route == "tc" else (0, 1)):
                raise AssertionError(f"flash {case} {dtype}: launched off its route {route}")
            what = f"flash {case} q_offset={off} {dtype} ({route})"
            errs[case, dtype] = compare(torch, what, got, ref.flash_attention_ref(q, k, v, causal, win, off), dtype)
            check_sensitive(torch, ref, what, got, q, k, v, causal, win, off, dtype)
            if dtype == "float32" or case in FLASH_CASES or case in (window, WIDE_BF16) or case in sweep:
                lse_errs[case, dtype] = check_lse(torch, fa, ref, what, got, q, k, v, causal, win, off, dtype)
    log(f"[kernels] flash: head dims {fa.TC_HEAD_DIMS} held in bf16 and f32, output and lse; on every case the "
        "check fails K with rolled columns and S = 0")
    B, H, Kh, S, _, D, causal, win = FLASH_TRAIN
    train = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, getattr(torch, dtype))
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
        what = f"flash {FLASH_TRAIN} {dtype} ({fa.route(q.dtype, D)}, the train shape)"
        err = compare(torch, what, got, ref.flash_attention_ref(q, k, v, causal, win, 0), dtype)
        check_sensitive(torch, ref, what, got, q, k, v, causal, win, 0, dtype)
        train[dtype] = err, check_lse(torch, fa, ref, what, got, q, k, v, causal, win, 0, dtype)
        del q, k, v, got
    log("[kernels] flash lse: on both routes, at every case above, the check fails an lse of S = 0 and one "
        "in log2 units")
    torch.cuda.synchronize()
    B, H, Kh, S, _, D, _, _ = cfg_case
    q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, True, 0, 0))
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    ops = 4 * B * H * D * flash_pairs(torch, S, S, True, 0, 0)  # QK^T and PV, 2 ops per MAC
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, ops, "bfloat16")  # q, o, k, v
    log(f"[kernels] flash {tuple(q.shape)}x{tuple(k.shape)} causal bf16 (tensor cores, {spills['tc']} spill "
        f"bytes): kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.3f}x), "
        f"bound {b_ms:.4f} ms ({b_by}), {ops / ms / 1e9:.2f} TFLOP/s")
    del q, k, v
    tc = dict({
        "name": "flash_attention", "route": "cuda", "kernel_route": "tc",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "shape": f"q {(B, H, S, D)} kv {(B, Kh, S, D)} causal bf16", "head_dims": list(fa.TC_HEAD_DIMS),
        "max_abs_err": errs[cfg_case, "bfloat16"], "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "spill_bytes": spills["tc"],
        "instances": instances["tc"], "head_dim_sweep_max_abs_err": {c[5]: errs[c, "bfloat16"] for c in sweep},
        "train_shape_max_abs_err": train["bfloat16"][0], "train_shape_lse_max_abs_err": train["bfloat16"][1],
    }, **time_flash_train_shape(torch, fa, ref, gen), **time_flash_wide(torch, fa, ref, gen))
    tc["wide_max_abs_err"] = errs[WIDE_BF16, "bfloat16"]
    f32 = dict({
        "name": "flash_attention_f32", "route": "cuda", "kernel_route": "f32",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "head_dims": list(fa.TC_HEAD_DIMS), "max_abs_err": errs[cfg_case, "float32"],
        "lse_max_abs_err": lse_errs[cfg_case, "float32"], "spill_bytes": spills["f32"],
        "instances": instances["f32"], "head_dim_sweep_max_abs_err": {c[5]: errs[c, "float32"] for c in sweep},
        "head_dim_sweep_lse_max_abs_err": {c[5]: lse_errs[c, "float32"] for c in sweep},
        "train_shape_max_abs_err": train["float32"][0], "train_shape_lse_max_abs_err": train["float32"][1],
    }, **time_flash_f32(torch, fa, ref, gen, cfg_case))
    return tc, f32


def time_flash_f32(torch, fa, ref, gen, serve_case):
    """The f32 forward at the serve shape (no lse, as the serve_f32 phase
    calls it) and at FLASH_TRAIN's shape with its lse (as the train step
    calls it), each against the plain version, SDPA in f32 on the same inputs
    (``allow_tf32`` is False: SDPA keeps its products in f32) and two
    bounds: the design's, three TF32 products on the tensor cores, and the
    CUDA cores' at 67 TFLOP/s."""
    out = {}
    for key, case, lse in (("", serve_case, False), ("train_shape_", FLASH_TRAIN, True)):
        B, H, Kh, S, _, D, causal, _ = case
        q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.float32)
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=lse))
        plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal, 0, 0, return_lse=lse), reps=5,
                        warmup=1)
        lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        backend = sdpa_kernels(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        ops = 4 * B * H * D * flash_pairs(torch, S, S, causal, 0, 0)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + (B * H * S * 4 if lse else 0)
        b_ms, b_by = bound(nbytes, F32_FLASH_PRODUCTS * ops, "tf32")
        core_ms, core_by = bound(nbytes, ops, "float32")
        shape = f"q {tuple(q.shape)} kv {tuple(k.shape)} causal f32{' with lse' if lse else ''}"
        log(f"[kernels] flash {shape} (f32 kernel, three TF32 products): kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, SDPA f32 {lib:.4f} ms ({ms / lib:.3f}x; its kernels {backend}), bound {b_ms:.4f} ms ({b_by}, "
            f"{F32_FLASH_PRODUCTS} x {ops / 1e9:.2f} GFLOP at the TF32 peak; {100 * b_ms / ms:.1f}% of it), "
            f"CUDA-core bound {core_ms:.4f} ms ({core_by}), {ops / ms / 1e9:.2f} TFLOP/s of f32 products")
        out.update({f"{key}shape": shape, f"{key}ms": ms, f"{key}kernel_ms": ms, f"{key}plain_ms": plain,
                    f"{key}library_ms": lib, f"{key}library_kernels": backend, f"{key}bound_ms": b_ms,
                    f"{key}bound_by": b_by, f"{key}cuda_core_bound_ms": core_ms,
                    f"{key}cuda_core_bound_by": core_by})
        del q, k, v
    return out


def check_lse(torch, fa, ref, what, out, q, k, v, causal, window, q_offset, dtype: str) -> float:
    """The kernel's log-sum-exp against the plain version's (+inf where a row
    sees no key), with the same output as without it; and the check must fail
    an lse of S = 0 (K zeroed) and one in log2 units, on the rows that see a
    key.  Returns the largest error on those rows."""
    got_out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                          return_lse=True)
    want = ref.flash_attention_ref(q, k, v, causal, window, q_offset, return_lse=True)[1]
    tol = TOL[dtype]
    if not torch.equal(got_out, out):
        raise AssertionError(f"{what}: the output changes when the kernel writes the lse")
    seen = torch.isfinite(want)
    if lse.dtype != torch.float32 or lse.shape != want.shape or not torch.equal(torch.isfinite(lse), seen) \
            or (lse[~seen] != want[~seen]).any():
        raise AssertionError(f"{what}: lse of the wrong type or shape, or not +inf exactly where no key is seen")
    err = (lse[seen] - want[seen]).abs().max().item() if seen.any() else 0.0
    log(f"[kernels] {what} lse: max_abs_err={err:.3e} tol={tol:g} {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        raise AssertionError(f"{what}: lse disagrees with its plain version (max_abs_err {err})")
    if seen.any():
        zero_s = ref.flash_attention_ref(q, torch.zeros_like(k), v, causal, window, q_offset, return_lse=True)[1]
        for wrong, bad in (("S = 0", zero_s), ("log2 units", want / math.log(2.0))):
            if torch.allclose(lse[seen], bad[seen], rtol=0, atol=tol):
                raise AssertionError(f"{what}: the lse check cannot tell the lse from one of {wrong}")
    return err


def time_flash_wide(torch, fa, ref, gen):
    """The tensor-core forward at WIDE_BF16 (head dim 256) against the plain
    version, SDPA on the same inputs and its bound."""
    B, H, Kh, S, _, D, causal, _ = WIDE_BF16
    q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal, 0, 0), reps=5, warmup=1)
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    ops = 4 * B * H * D * flash_pairs(torch, S, S, causal, 0, 0)
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, ops, "bfloat16")
    log(f"[kernels] flash {tuple(q.shape)}x{tuple(k.shape)} causal bf16 (tensor cores, D = {D}): kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.3f}x), bound {b_ms:.4f} ms "
        f"({b_by}), {ops / ms / 1e9:.2f} TFLOP/s")
    return {"wide_shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} causal bf16", "wide_ms": ms,
            "wide_plain_ms": plain, "wide_library_ms": lib, "wide_bound_ms": b_ms, "wide_bound_by": b_by}


def time_flash_train_shape(torch, fa, ref, gen):
    """The tensor-core forward at the train shape (one row of train_4k's
    batch, every head), without and with its lse, against SDPA on the same
    inputs and its bound; and the plain backward there."""
    B, H, Kh, S, _, D, causal, _ = FLASH_TRAIN
    q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    lse_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True))
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    bwd = time_ms(torch, lambda: ref.flash_attention_bwd(q, k, v, out, lse, dout, True, 0, 0), reps=5, warmup=1)
    ops = 4 * B * H * D * flash_pairs(torch, S, S, True, 0, 0)
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2 + B * H * S * 4, ops, "bfloat16")
    log(f"[kernels] flash {tuple(q.shape)}x{tuple(k.shape)} causal bf16 (tensor cores, the train shape): kernel "
        f"{ms:.4f} ms, with lse {lse_ms:.4f} ms, SDPA {lib:.4f} ms ({lse_ms / lib:.3f}x), bound {b_ms:.4f} ms "
        f"({b_by}), {ops / lse_ms / 1e9:.2f} TFLOP/s; the plain backward {bwd:.3f} ms")
    return {"train_shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} causal bf16", "train_shape_ms": ms,
            "train_shape_lse_ms": lse_ms, "train_shape_library_ms": lib, "train_shape_bound_ms": b_ms,
            "train_shape_bound_by": b_by, "train_shape_backward_plain_ms": bwd}


def check_flash_backward(torch, ops, gen):
    """The flash autograd function on the card (the tensor-core forward and
    its lse, the plain backward) against the CPU's (the plain forward and
    backward), bf16 at one row of the serve shape: each gradient within 2e-2
    of its largest magnitude (both forwards round P to bf16 for PV, each
    against its own running or row max)."""
    B, H, Kh, S, D = 1, 40, 8, PROMPT, 128
    q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.bfloat16)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    grads = []
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*ts, True, 0, 0)
        grads.append([g.float().cpu() for g in torch.autograd.grad(out, ts, dout.to(dev))])
    errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(*grads)]
    log(f"[kernels] flash backward {tuple(q.shape)}x{tuple(k.shape)} causal bf16, card (tensor-core forward) vs "
        f"CPU: dq, dk, dv max err / max magnitude {', '.join(f'{e:.3e}' for e in errs)} (tol 2e-2)")
    if max(errs) > 2e-2:
        raise AssertionError(f"flash backward on the card disagrees with the CPU's: {errs}")


def hop_chunks(cfg, C):
    """(chunks, elements per chunk) of the largest leaf (w_gate, d x d_ff) in
    the full-width sync: the layout each chain hop's dst is a row of."""
    n = cfg.d_model * cfg.d_ff
    nchunks = C.HOST_STAGED_CONFIG.chunks_for(SYNC_RANKS, n * 2)  # bf16
    return nchunks, -(-n // nchunks)


def check_chunk_reduce(torch, cr, ref, gen, nchunks: int, chunk: int):
    """Bit for bit against the plain version: the test sweeps, every row of
    a (C, chunk) bf16 and f32 buffer as ``collectives._to_chunks`` lays a leaf
    out (an odd chunk starts rows at every alignment) against a fresh src,
    and src views at every misalignment against an aligned dst.  Then times
    the hop on row 1 of the full-width (C, chunk) buffer in place, where dst
    starts 10 bytes past a 16-byte boundary and src is fresh, beside
    ``torch.add(dst, src, out=dst)`` on the same views; and on two fresh,
    aligned tensors, beside the same call."""
    def same(what, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"chunk_reduce {what}: not bit for bit the plain version")

    for n in (17, 4096, 100_000):
        for dtype in ("float32", "bfloat16", "float16"):
            dt = getattr(torch, dtype)
            for alpha in (1.0, 0.5):
                for into in ("new", "dst"):
                    dst = torch.randn(n, generator=gen, device="cuda").to(dt)
                    src = torch.randn(n, generator=gen, device="cuda").to(dt)
                    want = ref.chunk_reduce_ref(dst, src, alpha)
                    got = cr.chunk_reduce(dst, src, alpha, out=dst if into == "dst" else None)
                    compare(torch, f"chunk_reduce n={n} {dtype} alpha={alpha} out={into}", got, want, dtype)
                    same(f"n={n} {dtype}", got, want)
    for dtype in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype)
        rows = torch.randn(8, 10_007, generator=gen, device="cuda").to(dt)
        for k in range(8):
            for into in ("new", "dst"):
                src = torch.randn(10_007, generator=gen, device="cuda").to(dt)
                want = ref.chunk_reduce_ref(rows[k], src, 1.0)
                same(f"row {k} of (8, 10007) {dtype} out={into}",
                     cr.chunk_reduce(rows[k], src, 1.0, out=rows[k] if into == "dst" else None), want)
        big = torch.randn(10_007 + 8, generator=gen, device="cuda").to(dt)
        dst = torch.randn(10_007, generator=gen, device="cuda").to(dt)
        for off in range(16 // dst.element_size()):
            src = big[off : off + 10_007]
            same(f"src offset {off} {dtype}", cr.chunk_reduce(dst, src, 0.5), ref.chunk_reduce_ref(dst, src, 0.5))
    log("[kernels] chunk_reduce: bit for bit at every row of (8, 10007) and every src offset, f32, bf16 and f16")

    buf = torch.randn(nchunks, chunk, generator=gen, device="cuda").to(torch.bfloat16)
    dst = buf[1]
    src = torch.randn(chunk, generator=gen, device="cuda").to(torch.bfloat16)
    want = ref.chunk_reduce_ref(dst, src, 1.0)
    got = cr.chunk_reduce(dst, src, 1.0, out=dst)
    path_err = compare(torch, f"chunk_reduce row 1 of ({nchunks}, {chunk}) (the hop) bf16 out=dst",
                       got, want, "bfloat16")
    same("the hop's row", got, want)
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: cr.chunk_reduce(dst, src, 1.0, out=dst))
    plain = time_ms(torch, lambda: ref.chunk_reduce_ref(dst, src, 1.0))
    lib = time_ms(torch, lambda: torch.add(dst, src, out=dst))
    a = torch.randn(chunk, generator=gen, device="cuda").to(torch.bfloat16)
    aligned = time_ms(torch, lambda: cr.chunk_reduce(a, src, 1.0, out=a))
    aligned_lib = time_ms(torch, lambda: torch.add(a, src, out=a))
    b_ms, b_by = bound(3 * chunk * 2, 2 * chunk, "float32")  # f32 math on the CUDA cores
    log(f"[kernels] chunk_reduce row 1 of ({nchunks}, {chunk}) bf16 in place (dst {dst.data_ptr() % 16} bytes "
        f"past 16, src fresh): kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.add(out=dst) {lib:.4f} ms "
        f"({ms / lib:.3f}x), bound {b_ms:.4f} ms ({b_by})")
    log(f"[kernels] chunk_reduce ({chunk},) bf16 in place, fresh aligned tensors: kernel {aligned:.4f} ms, "
        f"torch.add(out=dst) {aligned_lib:.4f} ms")
    return {
        "name": "chunk_reduce", "route": "cuda", "source": "src/repro_torch/kernels/csrc/chunk_reduce.cu",
        "replaces": "src/repro/kernels/chunk_reduce.py:29",
        "shape": f"dst row 1 of ({nchunks}, {chunk}) bf16, src fresh, out = dst",
        "max_abs_err": path_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "aligned_ms": aligned, "aligned_library_ms": aligned_lib,
    }


def check_chunk_reduce_f16(torch, cr, ref, gen):
    """The f16 instance at the data plane's fold windows: a window of the
    32 MB object (2 MB: ``max(chunk, size/16)`` rounded to 64 bytes) and of
    the 1 GiB one (64 MB), folded in place as a fold writes its output
    window, against the plain version and ``torch.add(out=dst)``."""
    out = {}
    for obj, nbytes in (("32 MB", 2 << 20), ("1 GiB", 64 << 20)):
        n = nbytes // 2
        dst = torch.randn(n, generator=gen, device="cuda").half()
        src = torch.randn(n, generator=gen, device="cuda").half()
        want = ref.chunk_reduce_ref(dst, src, 1.0)
        got = cr.chunk_reduce(dst, src, 1.0, out=dst)
        err = compare(torch, f"chunk_reduce f16 window of the {obj} object ({n},) out=dst", got, want, "float16")
        if not torch.equal(got, want):
            raise AssertionError("chunk_reduce f16: not bit for bit the plain version")
        ms = time_ms(torch, lambda: cr.chunk_reduce(dst, src, 1.0, out=dst))
        plain = time_ms(torch, lambda: ref.chunk_reduce_ref(dst, src, 1.0))
        lib = time_ms(torch, lambda: torch.add(dst, src, out=dst))
        b_ms, b_by = bound(3 * nbytes, 2 * n, "float32")
        log(f"[kernels] chunk_reduce f16 ({n},) in place, a fold window of the {obj} object: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, torch.add(out=dst) {lib:.4f} ms ({ms / lib:.3f}x), bound {b_ms:.4f} ms ({b_by})")
        key = "f16" if obj == "32 MB" else "f16_1gib_window"
        out.update({f"{key}_shape": f"({n},) f16 in place", f"{key}_ms": ms, f"{key}_plain_ms": plain,
                    f"{key}_library_ms": lib, f"{key}_bound_ms": b_ms, f"{key}_bound_by": b_by,
                    f"{key}_max_abs_err": err})
    return out


def check_dequant_add(torch, cr, ref, compression, gen, leaf: int):
    path_err = None
    for n, dtypes in ((300, ("float32", "bfloat16")), (70_000, ("float32", "bfloat16")), (leaf, ("float32",))):
        for dtype in dtypes:
            dst = torch.randn(n, generator=gen, device="cuda").to(getattr(torch, dtype))
            q, scale = compression.quantize_int8(torch.randn(n, generator=gen, device="cuda"))
            q = q.reshape(-1)
            err = compare(torch, f"dequant_add n={n} {dtype}", cr.dequant_add(dst, q, scale),
                          ref.dequant_add_ref(dst, q, scale, 256), dtype)
            if n == leaf:
                path_err = err
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: cr.dequant_add(dst, q, scale))
    plain = time_ms(torch, lambda: ref.dequant_add_ref(dst, q, scale, 256))
    b_ms, b_by = bound(leaf * (2 * 4 + 1) + 4 * leaf / 256, 2 * leaf, "float32")
    log(f"[kernels] dequant_add n={leaf} f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"no library call, bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "dequant_add", "route": "cuda", "source": "src/repro_torch/kernels/csrc/chunk_reduce.cu",
        "replaces": "src/repro/kernels/chunk_reduce.py:69", "shape": f"dst ({leaf},) f32 (w_gate), q int8",
        "max_abs_err": path_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def layer_kinds(cfg):
    """The kind of each layer ("attn", "mamba", "rwkv"), stage by stage."""
    return [spec.kind for pattern, nblocks in cfg.stages() for _ in range(nblocks) for spec in pattern]


def expected_launches(cfg, decode_steps: int):
    """RMSNorm (none where ``cfg.norm`` is LayerNorm, plain PyTorch): ln1 and
    ln2 of every layer (an attention or Mamba layer's mixer and FFN, an RWKV
    block's two mixes) and the final norm; with qk-norm the norms of q and k
    of every attention layer, and in prefill its k-norm again
    (attention_prefill_kv recomputes k, as the JAX package does).  Flash
    attention: once per attention layer in prefill, on the route that
    ``flash_attention.route`` names for the config's type and head dim;
    decode has none.  Mamba and RWKV layers launch no kernel of the port.
    An encoder-decoder adds, in prefill, the encoder's layers (flash,
    bidirectional, and the norms of an attention layer) and its final norm,
    and in every decoder layer that has cross-attention (each but an RWKV
    block) a flash launch in prefill and its ln_cross in prefill and decode."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    kinds = layer_kinds(cfg)
    L, n_attn = cfg.num_layers, kinds.count("attn")
    E = cfg.encoder_layers
    n_cross = len(kinds) - kinds.count("rwkv") if E else 0
    rms = cfg.norm == "rmsnorm"
    qk = 2 * n_attn if cfg.qk_norm else 0
    per_decode = (2 * L + 1 + n_cross if rms else 0) + qk
    encoder = (2 * E + 1 if rms else 0) + (2 * E if cfg.qk_norm else 0) if E else 0
    prefill = per_decode + qk // 2 + encoder
    counts = {"rmsnorm": prefill + decode_steps * per_decode, "flash_attention_tc": 0,
              "flash_attention_f32": 0, "chunk_reduce": 0, "dequant_add": 0}
    counts[f"flash_attention_{fa.route(getattr(torch, cfg.dtype), cfg.head_dim)}"] = n_attn + E + n_cross
    return counts


def route_margin(logits, k: int):
    """The routing rule's margin, per token: the gap between its k-th and
    (k+1)-th router logits over its largest router-logit magnitude."""
    top = logits.sort(dim=-1, descending=True).values
    return (top[..., k - 1] - top[..., k]) / top.abs().amax(-1)


class RoutingLog:
    """While active, records each MoE layer's routing of the last token of
    its input: (that token's MoE input, its chosen experts, its router logits)."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        route, dense = self.moe._route, self.moe.dense

        def logged(cfg, p, x):
            w, aux = route(cfg, p, x)
            self.calls.append((x[:, -1].float(), w[:, -1] > 0, dense(x[:, -1], p["router"]).float()))
            return w, aux

        self.route, self.moe._route = route, logged
        return self.calls

    def __exit__(self, *exc):
        self.moe._route = self.route


def check_cache(torch, T, eng, toks, tag: str, inputs=None):
    """Decode step 1 against the last position of prefill(prompt + token);
    ``inputs`` (an encoder-decoder's frames) go to every prefill with the
    tokens.

    Both sides run bf16 weights and activations: the two paths round in
    different places (the flash kernel against decode's plain attention,
    matmuls of thousands of rows against a few), and the layers carry those
    roundings on.  Held as a relative L2 error of the logit vector against
    CACHE_REL_L2_TOL, and the greedy token must agree on most rows.

    With MoE layers, those roundings can move a router's choice where two
    experts' logits nearly tie, and the rows part from there.  The routing
    rule (tests/test_torch_moe.py holds the packages to it too): a row may
    route differently only where the prefill's ``route_margin`` lies within
    ROUTE_MARGIN, and only where both paths' MoE inputs still agree within
    CACHE_REL_L2_TOL; such a row is not compared, and at least half the rows
    must be.  tests/test_torch_moe.py shows that this check fails a ring slot
    off by one on the reduced mixtral, tests/test_torch_encdec.py a cross
    cache with two rows swapped or taken before the encoder's final norm."""
    from repro_torch.models import moe

    cfg, params, max_seq = eng.cfg, eng.params, eng.options.max_seq
    B, prompt = toks.shape
    inputs = inputs or {}
    with torch.inference_mode():
        logits, caches = T.prefill(cfg, params, dict(inputs, tokens=toks), max_seq)
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        first = logits[:, : cfg.vocab_size].argmax(-1)[:, None]  # greedy, as the engine
        with RoutingLog(moe) as dec:
            step1, _ = T.decode_step(cfg, params, first, prompt, caches)
        del caches
        with RoutingLog(moe) as pre:
            longer, _ = T.prefill(cfg, params, dict(inputs, tokens=torch.cat([toks, first], dim=1)), max_seq)
    if not torch.isfinite(step1).all():
        raise AssertionError("decode logits are not finite")
    rows, parted = torch.ones(B, dtype=torch.bool, device=toks.device), []
    for layer, ((xd, sd, _), (xp, sp, lp)) in enumerate(zip(dec, pre)):
        margin = route_margin(lp, cfg.top_k)
        x_rel = (xd - xp).norm(dim=-1) / xp.norm(dim=-1)
        for r in (rows & ~(sd == sp).all(-1)).nonzero()[:, 0].tolist():
            parted.append((r, layer, margin[r].item(), x_rel[r].item()))
            log(f"[{tag}] {cfg.name} cache check: row {r} routes differently at layer {layer}: margin "
                f"{margin[r].item():.3e} (rule {ROUTE_MARGIN:g}), MoE inputs {x_rel[r].item():.3e} apart")
            if margin[r] > ROUTE_MARGIN or x_rel[r] > CACHE_REL_L2_TOL:
                raise AssertionError(f"row {r} routes differently at layer {layer} outside the routing rule")
            rows[r] = False
    if 2 * int(rows.sum()) < B:
        raise AssertionError(f"the cache check compares {int(rows.sum())} of {B} rows")
    V = cfg.vocab_size
    a, b = step1[rows, :V].float(), longer[rows, :V].float()
    rel = ((a - b).norm() / b.norm()).item()
    max_abs = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[{tag}] {cfg.name} cache check: decode step 1 (position {prompt}) vs prefill(prompt + token) on "
        f"{int(rows.sum())} of {B} rows: rel_l2={rel:.3e} max_abs={max_abs:.3e} (|logit| max "
        f"{b.abs().max().item():.3f}) argmax agree {agree:.2f}")
    if rel > CACHE_REL_L2_TOL:
        raise AssertionError(f"decode disagrees with prefill: rel_l2 {rel} > {CACHE_REL_L2_TOL}")
    return rel, max_abs, parted


def serve_model(torch, card: str, cfg, batch: int, prompt: int, new_tokens: int, max_seq: int, tag: str,
                extra=None):
    """Serve ``cfg`` (weights of its ``param_dtype`` drawn on the card from
    SEED) through the engine: ``batch`` prompts of ``prompt`` tokens (and for an
    encoder-decoder their frames, ``launch.serve.random_batch``),
    ``new_tokens`` greedy tokens, caches of ``max_seq``.  The launches of that run must be
    ``expected_launches`` exactly, with no flash launch writing the lse; then
    the cache check, prefill (median of 3) and decode times, peak memory, and
    one profiled prefill and decode step.  ``extra(torch, eng, inputs, metrics)``,
    if given, measures more with the engine (``inputs``: prefill's batch on
    the card) and returns metrics to add."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_batch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeOptions
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    eng = build_engine(cfg, "cuda", SEED, ServeOptions(max_seq=max_seq, batch_size=batch))
    torch.cuda.synchronize()
    weight_gb = sum(t.numel() * t.element_size() for t in leaves(eng.params)) / 1e9
    log(f"[{tag}] {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, {weight_gb:.2f} GB of "
        f"{cfg.param_dtype} weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    host = random_batch(cfg, batch, prompt, SEED)
    inputs = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}  # prefill's, timed below
    toks = inputs["tokens"]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(host, new_tokens)  # the main path
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, new_tokens - 1)
    log(f"[{tag}] {cfg.name} generate: {out.shape} tokens in {gen_s:.3f} s; launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    flash = counts["flash_attention_tc"] + counts["flash_attention_f32"]
    log(f"[{tag}] flash launches that wrote the lse: {fa.lse_launches} of {flash}")
    if fa.lse_launches:
        raise AssertionError("the serve path's flash launches wrote the lse, which only gradients need")
    if out.shape != (batch, new_tokens) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"tokens out of range or of the wrong shape: {out.shape}, {out.min()}..{out.max()}")

    cache_in = {k: torch.as_tensor(v, device="cuda")
                for k, v in random_batch(cfg, max(batch, CACHE_ROWS), prompt, SEED).items()}
    rel, max_abs, parted = check_cache(torch, T, eng, cache_in.pop("tokens"), tag, cache_in)
    del cache_in

    with torch.inference_mode():
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = T.prefill(cfg, eng.params, inputs, max_seq)
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
        tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            logits, caches = T.decode_step(cfg, eng.params, tok, prompt + i, caches)
            tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (new_tokens - 1)
        prefill_ms = statistics.median(pre)
        prefill_busy, prefill_kinds = device_profile(
            torch, lambda: T.prefill(cfg, eng.params, inputs, max_seq), f"{cfg.name} prefill", prefill_ms)
        decode_busy, decode_kinds = device_profile(
            torch, lambda: T.decode_step(cfg, eng.params, tok, prompt + new_tokens - 1, caches),
            f"{cfg.name} decode step", dec_ms)
    log(f"[{tag}] {card}: {cfg.name} prefill {batch}x{prompt} {prefill_ms:.2f} ms (median of 3: "
        f"{', '.join(f'{t:.2f}' for t in pre)}), decode {dec_ms:.2f} ms per step of {batch} tokens, generate "
        f"{batch * new_tokens / gen_s:.1f} tok/s (prefill included), peak memory {peak_gb:.2f} GB")
    metrics = {"prefill_ms": prefill_ms, "prefill_runs_ms": pre, "decode_ms_per_step": dec_ms,
               "prefill_kernel_busy_ms": prefill_busy, "decode_kernel_busy_ms": decode_busy,
               "prefill_device_ms_by_kind": prefill_kinds, "decode_device_ms_by_kind": decode_kinds,
               "generate_tok_s": batch * new_tokens / gen_s, "generate_s": gen_s, "peak_gb": peak_gb,
               "cache_rel_l2": rel, "cache_max_abs": max_abs, "cache_rows_routed_apart": parted,
               "weight_gb": weight_gb}
    if extra is not None:
        metrics.update(extra(torch, eng, inputs, metrics))
    return counts, metrics


def serve(torch, card: str):
    from repro_torch.configs import get_config

    return serve_model(torch, card, get_config(ARCH), BATCH, PROMPT, NEW_TOKENS, MAX_SEQ, "serve")


def serve_f32(torch, card: str):
    """qwen3-14b at full width in f32 (the config's own ``dtype`` and
    ``param_dtype`` fields), its depth cut to F32_LAYERS, through
    ``serve_model``: every prefill's flash runs on the f32 kernel, at the
    kernel record's serve shape."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    full = get_config(ARCH)
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32", num_layers=F32_LAYERS)
    log(f"[serve_f32] {ARCH} at full width in f32 (d={cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv "
        f"heads, head dim {cfg.head_dim}), {F32_LAYERS} of {full.num_layers} layers; {BATCH} prompts of {PROMPT} "
        f"tokens, {F32_NEW_TOKENS} greedy tokens, max_seq {MAX_SEQ}")
    counts, metrics = serve_model(torch, card, cfg, BATCH, PROMPT, F32_NEW_TOKENS, MAX_SEQ, "serve_f32")
    metrics["phase_s"] = time.perf_counter() - t0
    log(f"[serve_f32] {metrics['phase_s']:.1f} s")
    return counts, metrics


def sdpa_kernels(torch, fn, top: int = 2):
    """The device kernels that took most of one profiled call of ``fn``: which
    backend SDPA chose."""
    per_name = device_events(torch, fn)[1]
    return [n[:80] for n, _ in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]]


def check_flash_at(torch, fa, ref, gen, arch: str, attention: str):
    """The flash forward at ``arch``'s prefill shape (its serve run's batch,
    every head, bf16) for its layers of ``attention`` (FLASH_PREFILL): the
    decoder's causal self-attention over the prompt ("full", "window"), the
    encoder's bidirectional self-attention over the frames ("encoder") or
    the prompt against the frames ("cross"); on the route ``fa.route``
    names.  Output and lse against the plain version, the wrong-Q.K^T checks
    and, windowed, a check that full causal attention is told apart; then
    its time against its bound, the plain version's and SDPA's (with the
    window as a boolean mask)."""
    from repro_torch.configs import get_config

    cfg, (_, B, S, _, _) = get_config(arch), SERVE_RUNS[arch]
    H, Kh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E = cfg.encoder_seq
    Sq, Skv = {"encoder": (E, E), "cross": (S, E)}.get(attention, (S, S))
    causal = attention not in ("encoder", "cross")
    win = next(s.window for s in cfg.pattern + cfg.tail_pattern if s.attention == attention) if causal else 0
    case = (B, H, Kh, Sq, Skv, D, causal, win)
    q, k, v = flash_inputs(torch, gen, B, H, Kh, Sq, Skv, D, torch.bfloat16)
    route = fa.route(torch.bfloat16, D)
    before = (fa.launches_tc, fa.launches_f32)
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
    if (fa.launches_tc - before[0], fa.launches_f32 - before[1]) != ((1, 0) if route == "tc" else (0, 1)):
        raise AssertionError(f"flash {case}: launched off its route {route}")
    what = f"flash {case} bf16 ({route}, {arch}'s {attention} prefill shape)"
    err = compare(torch, what, got, ref.flash_attention_ref(q, k, v, causal, win, 0), "bfloat16")
    check_sensitive(torch, ref, what, got, q, k, v, causal, win, 0)
    lse_err = check_lse(torch, fa, ref, what, got, q, k, v, causal, win, 0, "bfloat16")
    if win and torch.allclose(got.float(), ref.flash_attention_ref(q, k, v, causal, 0, 0).float(),
                              rtol=TOL["bfloat16"], atol=TOL["bfloat16"]):
        raise AssertionError(f"{what}: the check cannot tell the window from full causal attention")
    if win:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < win)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                        enable_gqa=H != Kh)
    else:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                        enable_gqa=H != Kh)
    compare(torch, f"SDPA at {case} (against the plain version)", sdpa(),
            ref.flash_attention_ref(q, k, v, causal, win, 0), "bfloat16")
    del got
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal, window=win))
    plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal, win, 0), reps=5, warmup=1)
    lib = time_ms(torch, sdpa)
    backend = sdpa_kernels(torch, sdpa)
    pairs = flash_pairs(torch, Sq, Skv, causal, win, 0)
    ops = 4 * B * H * D * pairs
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, ops, "bfloat16")
    shape = (f"q {tuple(q.shape)} kv {tuple(k.shape)} {'causal' if causal else 'bidirectional'}"
             f"{f' window {win}' if win else ''} bf16")
    log(f"[kernels] flash {shape} ({route} kernel, {arch}'s {attention} "
        f"prefill shape, {pairs} visible pairs per head): kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA "
        f"{lib:.4f} ms ({ms / lib:.3f}x; its kernels {backend}), bound {b_ms:.4f} ms ({b_by}, "
        f"{ops / 1e9:.1f} GFLOP, {(2 * q.numel() + k.numel() + v.numel()) * 2 / 1e6:.1f} MB), "
        f"{ops / ms / 1e9:.2f} TFLOP/s")
    del q, k, v
    return {"shape": shape, "kernel_route": route, "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "library_kernels": backend, "bound_ms": b_ms, "bound_by": b_by}


def check_moe_dispatch(torch):
    """One full-width mixtral MoE layer (bf16 weights drawn on the card from
    SEED: the router and 8 experts of 6144 x 16384) on MOE_LAYER_TOKENS
    tokens of std 1.  ``moe_fwd_dropping`` with capacity_factor = E / k,
    which drops no token, is held to ``moe_fwd``: two formulations of one
    function (a gather, per-expert f32 products and an f32 combine against
    one f32 contraction over experts and d_ff of the router-weighted h), to
    MOE_DISPATCH_TOL of the dense output's largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p = init_params(moe.moe_skel(cfg), gen, "cuda", dtype_override=cfg.param_dtype)
    B, S = MOE_LAYER_TOKENS
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(torch.bfloat16)
    room = cfg.num_experts / cfg.top_k
    with torch.inference_mode():
        dense, dense_aux = moe.moe_fwd(cfg, p, x)
        drop, drop_aux = moe.moe_fwd_dropping(cfg, p, x, capacity_factor=room)
        a, b = drop.float(), dense.float()
        err = ((a - b).abs().max() / b.abs().max()).item()
        rel = ((a - b).norm() / b.norm()).item()
        log(f"[serve_moe] one full-width {cfg.name} MoE layer on {B}x{S} tokens, bf16: dropping (capacity factor "
            f"{room:g}, no token drops) vs dense: max err / max magnitude {err:.3e} (tol {MOE_DISPATCH_TOL:g}), "
            f"rel_l2 {rel:.3e}, aux {drop_aux.item():.6f} vs {dense_aux.item():.6f}")
        if not torch.isfinite(a).all() or err > MOE_DISPATCH_TOL or not torch.equal(drop_aux, dense_aux):
            raise AssertionError(f"the dropping dispatch disagrees with the dense one: {err}, {rel}")
    return {"max_err_over_max": err, "rel_l2": rel}


def serve_runs(torch, card: str, runs, tag: str, describe, extra=None):
    """Serve each arch of ``runs`` ({arch: (layers kept, batch, prompt, greedy
    tokens, max_seq)}) at full width, its depth cut to the layers kept by
    ``dataclasses.replace``, through ``serve_model``; each engine is freed
    before the next.  ``describe(cfg, full)`` names what the run holds.
    Returns the launches of the runs' generate, summed, and each run's
    metrics."""
    import dataclasses

    from repro_torch.configs import get_config

    counts, metrics = {}, {}
    for arch, (layers, batch, prompt, new_tokens, max_seq) in runs.items():
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        log(f"[{tag}] {arch} at full width ({describe(cfg, full)}), {layers} of {full.num_layers} layers "
            f"({full.param_count() / 1e9:.1f} B parameters in all); {batch} prompts of {prompt} tokens, "
            f"{new_tokens} greedy tokens, max_seq {max_seq}")
        c, m = serve_model(torch, card, cfg, batch, prompt, new_tokens, max_seq, tag, extra)
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        m["phase_s"] = time.perf_counter() - t0
        m["launches"] = c
        metrics[arch] = m
        log(f"[{tag}] {arch}: {m['phase_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return counts, metrics


def serve_moe(torch, card: str):
    """The MoE family (MOE_RUNS): mixtral-8x22b, then llama4-scout-17b-a16e."""

    def describe(cfg, full):
        spec = cfg.pattern[0]
        return (f"d={cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads, head dim {cfg.head_dim}, d_ff "
                f"{cfg.d_ff}, {cfg.num_experts} experts top-{cfg.top_k}"
                f"{' and a shared expert' if cfg.shared_expert else ''}, {spec.attention} attention"
                f"{f' of window {spec.window}' if spec.window else ''}, vocab {cfg.vocab_size}; "
                f"{full.param_count() * 2 / 1e9:.0f} GB in bf16 in all")

    return serve_runs(torch, card, MOE_RUNS, "serve_moe", describe)


def serve_dense(torch, card: str):
    """The rest of the dense-attention family (DENSE_RUNS): gemma3-27b,
    starcoder2-3b, stablelm-3b, then qwen2-vl-72b."""
    from repro_torch.kernels import flash_attention as fa

    def describe(cfg, full):
        windows = sorted({s.window for s in cfg.pattern + cfg.tail_pattern if s.attention == "window"})
        return (f"d={cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads, head dim {cfg.head_dim} "
                f"(flash on the {fa.route(torch.bfloat16, cfg.head_dim)} route), d_ff {cfg.d_ff} {cfg.act}, "
                f"{cfg.norm}{' with qk-norm' if cfg.qk_norm else ''}, {cfg.rope}"
                f"{f' sections {cfg.mrope_sections}' if cfg.mrope_sections else ''}, "
                f"{f'windows {windows} and ' if windows else ''}{len(cfg.stages())} stage(s), vocab {cfg.vocab_size}")

    return serve_runs(torch, card, DENSE_RUNS, "serve_dense", describe)


def scan_inputs(torch, cfg, B: int, S: int):
    """Inputs of one layer's scan at (B, S), f32 on the card, from SEED: for
    RWKV (r, k, v, w, u, state) of ``ssm._wkv6_scan``, decays in (0, 1); for
    Mamba (delta, B, C, x, A, h) of ``ssm._selective_scan``, steps > 0 and
    A < 0.  The states start at zero, as in prefill."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if cfg.pattern[0].kind == "rwkv":
        H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
        r, k, v = (randn(B, S, H, hs) for _ in range(3))
        return r, k, v, torch.sigmoid(randn(B, S, H, hs) + 2), randn(H, hs), torch.zeros(B, H, hs, hs, device="cuda")
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
    delta = torch.nn.functional.softplus(randn(B, S, di) - 2)
    return (delta, randn(B, S, N), randn(B, S, N), randn(B, S, di), -torch.exp(randn(di, N) * 0.5),
            torch.zeros(B, di, N, device="cuda"))


def scans_bracketed(torch, fn):
    """One call of ``fn`` with every scan it makes (``ssm._wkv6_scan`` and
    ``ssm._selective_scan``) bracketed by CUDA events: (the scans' summed
    span on the card's stream in ms, the number of scans, the wall ms of the
    call).  A span runs from the stream reaching the scan to its last step's
    end, idle gaps included: on a host-bound loop, the wall time it holds."""
    from repro_torch.models import ssm

    spans, originals = [], (ssm._wkv6_scan, ssm._selective_scan)

    def bracketed(scan):
        def run(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = scan(*args)
            end.record()
            spans.append((start, end))
            return out
        return run

    ssm._wkv6_scan, ssm._selective_scan = (bracketed(f) for f in originals)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        ssm._wkv6_scan, ssm._selective_scan = originals
    return sum(s.elapsed_time(e) for s, e in spans), len(spans), wall


def measure_scans(torch, eng, batch, metrics):
    """The scans of a served SSM model: one layer's scan alone at the prefill
    shape (``time_ms``, 3 runs; the device busy time and device events of one
    profiled call), and the share of one prefill and of one decode step that
    its scans take (``scans_bracketed``)."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T

    toks = batch["tokens"]
    cfg, B, S = eng.cfg, toks.shape[0], toks.shape[1]
    rwkv = cfg.pattern[0].kind == "rwkv"
    name = "_wkv6_scan" if rwkv else "_selective_scan"
    inputs = scan_inputs(torch, cfg, B, S)
    scan = lambda: getattr(ssm, name)(*inputs, False)
    with torch.inference_mode():
        alone_ms = time_ms(torch, scan, reps=3, warmup=1)
        events, _ = device_events(torch, scan)
        busy = busy_ms(events)
        del inputs
        pre_ms, pre_n, pre_wall = scans_bracketed(torch, lambda: T.prefill(cfg, eng.params, {"tokens": toks},
                                                                           eng.options.max_seq))
        _, caches = T.prefill(cfg, eng.params, {"tokens": toks}, eng.options.max_seq)
        tok = toks[:, -1:]
        dec_ms, dec_n, dec_wall = scans_bracketed(torch, lambda: T.decode_step(cfg, eng.params, tok, S, caches))
        del caches
    shape = (B, S, cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size) if rwkv else \
        (B, S, cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim)
    log(f"[serve_ssm] {cfg.name} {name} alone at {shape} f32: {alone_ms:.2f} ms (time_ms, median of 3), device "
        f"busy {busy:.2f} ms ({100 * busy / alone_ms:.1f}%), {len(events)} device events ({len(events) / S:.1f} "
        f"per step)")
    log(f"[serve_ssm] {cfg.name} scans in one prefill: {pre_n} scans, {pre_ms:.2f} ms of {pre_wall:.2f} ms "
        f"({100 * pre_ms / pre_wall:.1f}%); in one decode step: {dec_n} scans, {dec_ms:.3f} ms of "
        f"{dec_wall:.2f} ms ({100 * dec_ms / dec_wall:.1f}%)")
    if not pre_n == dec_n == layer_kinds(cfg).count("rwkv" if rwkv else "mamba"):
        raise AssertionError(f"{cfg.name}: {pre_n} scans in prefill, {dec_n} in decode")
    return {"scan": name, "scan_shape": list(shape), "scan_alone_ms": alone_ms, "scan_alone_busy_ms": busy,
            "scan_alone_device_events": len(events), "scan_device_events_per_step": len(events) / S,
            "prefill_scans": pre_n, "prefill_scan_ms": pre_ms, "prefill_scan_wall_ms": pre_wall,
            "prefill_scan_share": pre_ms / pre_wall, "decode_scans": dec_n, "decode_scan_ms": dec_ms,
            "decode_scan_wall_ms": dec_wall, "decode_scan_share": dec_ms / dec_wall}


def serve_ssm(torch, card: str):
    """The SSM families (SSM_RUNS): rwkv6-1.6b at full depth, then
    jamba-v0.1-52b cut to one period; each run's metrics hold its scans'
    (``measure_scans``)."""

    def describe(cfg, full):
        kinds = layer_kinds(cfg)
        mixer = (f"{cfg.d_model // cfg.rwkv_head_size} wkv heads of {cfg.rwkv_head_size}" if "rwkv" in kinds else
                 f"Mamba di={cfg.ssm_expand * cfg.d_model} N={cfg.ssm_state_dim} conv {cfg.ssm_conv_width} dt_rank "
                 f"{max(1, cfg.d_model // 16)}, attention {cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
                 f"{cfg.head_dim} with rope={cfg.rope}, {cfg.num_experts} experts top-{cfg.top_k}")
        return (f"d={cfg.d_model}, d_ff {cfg.d_ff}, {cfg.norm}, vocab {cfg.vocab_size}; {mixer}; the layers kept: "
                + ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds))))

    return serve_runs(torch, card, SSM_RUNS, "serve_ssm", describe, extra=measure_scans)


def measure_encoder(torch, eng, batch, metrics):
    """The encoder of a served encoder-decoder: its time alone on prefill's
    frames (``T._run_encoder``, host clock around a synchronised call,
    median of 3), its share of the prefill's median, and its device busy
    time and time by kind in one profiled call; the bytes of the cross
    caches that prefill writes, K and V of (B, E, K, D) in the model's type
    for every layer with cross-attention (an RWKV block has none)."""
    from repro_torch.models import transformer as T

    cfg, frames = eng.cfg, batch["encoder_frames"]
    runs = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = T._run_encoder(cfg, eng.params, frames)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        if enc.shape != frames.shape or enc.dtype != getattr(torch, cfg.dtype) or not torch.isfinite(enc).all():
            raise AssertionError(f"encoder output {tuple(enc.shape)} {enc.dtype}, not finite or of the wrong shape")
        del enc
        enc_ms = statistics.median(runs)
        busy, kinds = device_profile(torch, lambda: T._run_encoder(cfg, eng.params, frames), f"{cfg.name} encoder",
                                     enc_ms)
    B, E = frames.shape[:2]
    cross_layers = sum(kind != "rwkv" for kind in layer_kinds(cfg))
    itemsize = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    cross_gb = 2 * cross_layers * B * E * cfg.num_kv_heads * cfg.head_dim * itemsize / 1e9
    log(f"[serve_encdec] {cfg.name} encoder ({cfg.encoder_layers} layers, {B} x {E} frames): {enc_ms:.2f} ms "
        f"(median of 3: {', '.join(f'{t:.2f}' for t in runs)}), {100 * enc_ms / metrics['prefill_ms']:.1f}% of "
        f"the {metrics['prefill_ms']:.2f} ms prefill; cross caches {cross_gb:.3f} GB")
    return {"encoder_ms": enc_ms, "encoder_runs_ms": runs, "encoder_share_of_prefill": enc_ms / metrics["prefill_ms"],
            "encoder_kernel_busy_ms": busy, "encoder_device_ms_by_kind": kinds, "cross_cache_gb": cross_gb}


def serve_encdec(torch, card: str):
    """The encoder-decoder (ENCDEC_RUNS): whisper-medium whole; each run's
    metrics hold its encoder's (``measure_encoder``)."""

    def describe(cfg, full):
        return (f"d={cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim} (MHA), d_ff {cfg.d_ff} {cfg.act}, "
                f"{cfg.norm}, rope={cfg.rope} with sinusoidal positions, vocab {cfg.vocab_size}; "
                f"{cfg.encoder_layers} encoder layers over {cfg.encoder_seq} frames a row, cross-attention in "
                f"every decoder layer; {full.param_count() * 2 / 1e9:.2f} GB in bf16 in all")

    return serve_runs(torch, card, ENCDEC_RUNS, "serve_encdec", describe, extra=measure_encoder)


def sync(torch, card: str):
    """The cross-pod gradient sync on SYNC_RANKS processes that share the card.
    ``launch.sync.run`` raises if any rank's check fails (launches against the
    schedules' prediction, the seeded mean, rank agreement)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sync as S
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    summary = S.run(cfg, SYNC_RANKS, "cuda", SEED)
    elems = sum(math.prod(p.shape) for p in leaves(T.layer_skel(cfg, cfg.pattern[0])))
    lk = summary["link"]
    log(f"[sync] {SYNC_RANKS} ranks on one card, one block of {cfg.name} per rank "
        f"(~{elems * 2 / 1e9:.2f} GB of bf16 gradients), phase {time.perf_counter() - t0:.1f} s")
    log(f"[sync] link (gloo through pinned host buffers, between two rank processes on {card}): "
        f"latency {lk['latency_s'] * 1e6:.2f} us ({lk['small_bytes']} B), bandwidth "
        f"{lk['bandwidth_Bps'] / 1e9:.4f} GB/s ({lk['large_bytes']} B; half round trip "
        f"{lk['large_half_rtt_s'] * 1e3:.3f} ms)")
    log(f"[sync] link under load (all {SYNC_RANKS} ranks exchange around the ring at once): latency "
        f"{lk['ring']['latency_s'] * 1e6:.2f} us, bandwidth {lk['ring']['bandwidth_Bps'] / 1e9:.4f} GB/s "
        f"(step of {lk['large_bytes']} B: {lk['ring']['large_step_s'] * 1e3:.3f} ms)")
    for name, m in summary["methods"].items():
        log(f"[sync] {name}: {m['wall_s'] * 1e3:.1f} ms (slowest rank), chunk_reduce launches per rank "
            f"{m['chunk_reduce']} (as predicted), max abs err vs the seeded mean {m['max_abs_err']:.3e}, "
            f"ranks agree bit for bit: {m['ranks_agree']}")
    for name, m in summary["methods"].items():  # each rank's count was held to its prediction
        if (sum(m["chunk_reduce"]) > 0) != (name != "psum"):
            raise AssertionError(f"{name}: hop kernel launches {m['chunk_reduce']}")
    return summary


def expected_train_launches(cfg, options):
    """Launches of one train step.  Per microbatch, the forward runs 4 RMSNorms
    in each layer (ln1, ln2, the qk-norm of q and of k) and the final norm,
    and one flash forward per layer, on the tensor cores (bf16, head dim
    128); remat (full or dots) runs each layer's forward once more in the
    backward.  The backward passes are plain PyTorch: no launch."""
    L, runs = cfg.num_layers, 1 if options.remat == "none" else 2
    n = options.num_microbatches
    return {"rmsnorm": n * (4 * L * runs + 1), "flash_attention_tc": n * L * runs, "flash_attention_f32": 0,
            "chunk_reduce": 0, "dequant_add": 0}


def check_train_gradients(torch):
    """The train path's loss and gradients at full width, held to an
    independent computation: qwen3-14b cut to one layer, one microbatch of
    train_4k (1 x TRAIN_SEQ tokens), bf16 weights from seed SEED with norm
    weights drawn too.  The path under test is ``train_loss`` with autograd
    on the card: the tensor-core flash forward with its lse, the RMSNorm
    kernel, their plain backward passes, the logits' f32 product.  The
    reference is the same weights in f32 through plain autograd of
    ``ref.flash_attention_ref`` and ``ref.rmsnorm_ref`` (no kernel, no
    hand-written backward; TF32 is off).  Every gradient leaf must lie
    within GRAD_REL_L2_TOL (relative L2) of the reference's, and the check
    must fail the attention gradients that an lse off by ln 2 gives (p
    halved in the backward)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(ARCH), num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(T.model_skel(cfg), gen, "cuda", dtype_override=cfg.param_dtype)
    for w in (params["final_norm"]["w"], *(params["stages"][0]["pos0"][n]["w"] for n in ("ln1", "ln2")),
              params["stages"][0]["pos0"]["attn"]["q_norm"], params["stages"][0]["pos0"]["attn"]["k_norm"]):
        w.normal_(0.0, 0.3, generator=gen)  # zeros would hide the 1 + w
    batch = pipeline.device_batch(cfg, ShapeSpec("train_4k, one microbatch", TRAIN_SEQ, 1, "train"), 0,
                                  torch.device("cuda"), SEED)
    names = [n for n, _ in _named_leaves(params)]

    def kernel_path():
        ps = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = T.train_loss(cfg, ps, batch)
        return loss.item(), [g.float() for g in torch.autograd.grad(loss, list(leaves(ps)))]

    before = ops.launch_counts()
    loss, grads = kernel_path()
    launched = {k: n - before[k] for k, n in ops.launch_counts().items()}
    if launched["flash_attention_tc"] != 1 or launched["rmsnorm"] != 5:
        raise AssertionError(f"train gradients: the kernel path launched {launched}")

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.detach().float().requires_grad_(), params)
    kernels = ops.flash_attention, ops.rmsnorm
    ops.flash_attention, ops.rmsnorm = ref.flash_attention_ref, ref.rmsnorm_ref
    try:
        before = ops.launch_counts()
        loss32 = T.train_loss(cfg32, p32, batch)
        want = torch.autograd.grad(loss32, list(leaves(p32)))
        if ops.launch_counts() != before:
            raise AssertionError("train gradients: the f32 reference launched a kernel")
    finally:
        ops.flash_attention, ops.rmsnorm = kernels
    del p32
    rel = lambda g, w: ((g - w).norm() / w.norm()).item()
    errs = {n: rel(g, w) for n, g, w in zip(names, grads, want)}
    log(f"[train] gradients at full width (1 layer, 1 x {TRAIN_SEQ} tokens), bf16 kernel path vs plain f32 "
        f"autograd: loss {loss:.6f} vs {loss32.item():.6f}; relative L2 per leaf (tol {GRAD_REL_L2_TOL:g}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    if max(errs.values()) > GRAD_REL_L2_TOL or abs(loss - loss32.item()) > 2e-2 * abs(loss32.item()):
        raise AssertionError(f"train gradients disagree with plain f32 autograd: {errs}")

    plain_bwd = ref.flash_attention_bwd
    ref.flash_attention_bwd = lambda q, k, v, out, lse, *a: plain_bwd(q, k, v, out, lse + math.log(2.0), *a)
    try:
        _, bad = kernel_path()
    finally:
        ref.flash_attention_bwd = plain_bwd
    bad_errs = {n: rel(g, w) for n, g, w in zip(names, bad, want) if "/attn/" in n}
    log("[train] with the lse off by ln 2 the attention leaves lie " + ", ".join(
        f"{n} {e:.3e}" for n, e in bad_errs.items()))
    if max(bad_errs.values()) <= GRAD_REL_L2_TOL:
        raise AssertionError("train gradients: the check cannot tell an lse off by ln 2")
    return {"grad_rel_l2": errs, "loss_bf16": loss, "loss_f32": loss32.item()}


def _named_leaves(tree, path=""):
    """(path, leaf) in ``tree.leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def train(torch, card: str):
    """The train step at full width through ``launch.train.run``: qwen3-14b cut
    to TRAIN_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ tokens a step in
    TRAIN_MICRO microbatches, full remat, one pod, TRAIN_STEPS steps."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves, tree_map

    full = get_config(ARCH)
    cfg = dataclasses.replace(full, num_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k, batch cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    opts = TS.TrainOptions(num_microbatches=TRAIN_MICRO, remat="full", pod_sync="gspmd")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] {cfg.name} at full width (d={cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), cut: {TRAIN_LAYERS} of {full.num_layers} layers "
        f"({cfg.param_count() / 1e9:.2f} B parameters; 40 layers' weights, f32 moments and f32 gradient sums, "
        f"{full.param_count() * 14 / 1e9:.0f} GB, do not fit one card), global batch {TRAIN_BATCH} of train_4k's "
        f"256 rows of {TRAIN_SEQ} tokens ({tokens} tokens a step) in {TRAIN_MICRO} microbatches, remat "
        f"{opts.remat}, one pod, {cfg.param_dtype} weights from seed {SEED}, AdamW {opts.adamw}")
    grad_check = check_train_gradients(torch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, recs = LT.run(cfg, shape, opts, "cuda", steps=TRAIN_STEPS, seed=SEED, log_every=1,
                         log=lambda m: log(f"[train] {m}"))  # the main path
    phase_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    lse_launches = fa.lse_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state_gb = sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9
    want = expected_train_launches(cfg, opts)
    for r in recs:
        log(f"[train] step {r['step']}: loss {r['loss']:.6f} gnorm {r['grad_norm']:.6f} lr {r['lr']:.3e} "
            f"{r['ms']:.2f} ms ({tokens / r['ms'] * 1e3:.1f} tok/s); launches {r['launches']}")
    log(f"[train] {TRAIN_STEPS} steps in {phase_s:.1f} s (state drawn included); peak memory "
        f"{peak_gb:.2f} GB (max_memory_allocated), state {state_gb:.2f} GB; launches {counts}, expected "
        f"{want} a step")
    losses = [r["loss"] for r in recs]
    if len(recs) != TRAIN_STEPS or not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs):
        raise AssertionError(f"train: {len(recs)} steps, losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"train: first loss {losses[0]} is not within 1.0 of ln({cfg.vocab_size})")
    if any(r["launches"] != want for r in recs) or counts != {k: TRAIN_STEPS * n for k, n in want.items()}:
        raise AssertionError(f"train: launches {[r['launches'] for r in recs]} (in all {counts}), expected {want} a step")
    log(f"[train] flash launches that wrote the lse: {lse_launches} of {counts['flash_attention_tc']}")
    if lse_launches != counts["flash_attention_tc"]:
        raise AssertionError("train: a flash launch under autograd wrote no lse")

    step_ms = statistics.median(r["ms"] for r in recs[1:])
    batch = pipeline.device_batch(cfg, shape, TRAIN_STEPS, torch.device("cuda"), SEED)
    train_step = TS.make_train_step(cfg, opts)
    busy, kinds = device_profile(torch, lambda: train_step(state, batch), "train step", step_ms, top=10)

    # The optimizer's share of a step: AdamW over the whole state with f32
    # gradients of every parameter, as the microbatched step hands it.
    grads = tree_map(lambda p: torch.full(p.shape, 1e-3, dtype=torch.float32, device=p.device), state["params"])
    opt_ms = time_ms(torch, lambda: adamw.adamw_update(grads, state["opt"], state["params"], opts.adamw),
                     reps=3, warmup=1)
    n = sum(p.numel() for p in leaves(state["params"]))
    moved = sum(p.numel() * p.element_size() * 2 for p in leaves(state["params"])) + n * (4 + 2 * 8)
    opt_bound, _ = bound(moved, 0, "float32")  # p read and written, g read, m and v read and written
    log(f"[train] AdamW over {n / 1e9:.2f} B parameters: {opt_ms:.2f} ms of the {step_ms:.2f} ms step, bound "
        f"{opt_bound:.2f} ms (bytes: {moved / 1e9:.1f} GB)")
    return counts, {"step_ms": [r["ms"] for r in recs], "tok_s": [tokens / r["ms"] * 1e3 for r in recs],
                    "loss": losses, "grad_norm": [r["grad_norm"] for r in recs], "lr": [r["lr"] for r in recs],
                    "peak_gb": peak_gb, "state_gb": state_gb, "step_kernel_busy_ms": busy,
                    "step_device_ms_by_kind": kinds,
                    "adamw_ms": opt_ms, "adamw_bound_ms": opt_bound, "gradient_check": grad_check,
                    "layers": TRAIN_LAYERS, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO}


# The dry run's memory prediction must lie within this share of the measured peak.
DRYRUN_RTOL = 0.10
# Calls a dispatch-cost timing makes of each entry point, and the rows of its
# RMSNorm: one decode step of the serve phase's 4 prompts.
DISPATCH_CALLS, DISPATCH_ROWS = 2000, 4


def dispatch_cost(torch):
    """Host time per call of the custom ops against the wrappers they call, at
    a decode shape (RMSNorm over 4 rows of 5120, one decode step's ln1) and
    the serve prefill's flash shape: the calls enqueue back to back and the
    card keeps up with them, so the time is the host's.  In turns: wrapper,
    op, op, wrapper; microseconds a call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(DISPATCH_ROWS, 1, 5120, device="cuda", dtype=torch.bfloat16, generator=gen)
    w = torch.zeros(5120, device="cuda", dtype=torch.bfloat16)
    q = torch.randn(1, 40, 64, 128, device="cuda", dtype=torch.bfloat16, generator=gen)
    kv = torch.randn(1, 8, 64, 128, device="cuda", dtype=torch.bfloat16, generator=gen)
    pairs = {"rmsnorm (4, 1, 5120)": (lambda: rn.rmsnorm(x, w), lambda: ops.rmsnorm(x, w)),
             "flash (1, 40, 64, 128)": (lambda: fa.flash_attention_fwd(q, kv, kv), lambda: ops.flash_attention(q, kv, kv))}
    out = {}
    for name, (plain, op) in pairs.items():
        times = {"wrapper": [], "custom op": []}
        for which, fn in (("wrapper", plain), ("custom op", op), ("custom op", op), ("wrapper", plain)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t) / DISPATCH_CALLS * 1e6)
        out[name] = {k: v for k, v in times.items()}
    return out


def dryrun(torch, card: str, train_metrics, device: str = "cuda"):
    """The dry run's trace of the train phase's own step, on the card's
    machine: qwen3-14b at full width cut to TRAIN_LAYERS layers, TRAIN_BATCH x
    TRAIN_SEQ tokens in TRAIN_MICRO microbatches, full remat, one pod, as
    fake tensors on the ``cuda`` device (``FakeTensorMode``: the step's
    products branch on the device type, so the trace takes the card's
    branches), with no mesh: ``launch.dryrun.trace_cell``, ``MemTracker``
    and ``launch.op_cost`` over one step.  Its predicted peak must lie
    within DRYRUN_RTOL of the train phase's ``max_memory_allocated``.  It also
    prints the step's traced FLOPs and their share of the card's bf16 peak at
    the measured median step time, and the custom ops' host cost a call.
    Nothing is written to disk and no kernel is launched by the trace."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k, batch cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    opts = TS.TrainOptions(num_microbatches=TRAIN_MICRO, remat="full", pod_sync="gspmd")
    t0 = time.perf_counter()
    with FakeTensorMode():
        fake = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device)
        state = tree_map(fake, TS.abstract_state(cfg))
        batch = tree_map(fake, specs.train_batch_specs(cfg, shape))
        rec = DR.trace_cell(TS.make_train_step(cfg, opts), (state, batch))
    trace_s = time.perf_counter() - t0
    mem, walk = rec["memory"], rec["walker"]
    measured = train_metrics["peak_gb"] * 1e9
    ratio = mem["peak_bytes"] / measured
    log(f"[dryrun] traced (fake {device} tensors, no mesh, no device work) in {trace_s:.1f} s: arguments "
        f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, predicted peak {mem['peak_bytes'] / 1e9:.2f} GB "
        f"(temp {mem['temp_size_in_bytes'] / 1e9:.2f} GB) against the train phase's max_memory_allocated "
        f"{measured / 1e9:.2f} GB: ratio {ratio:.4f}; on {card}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = statistics.median(train_metrics["step_ms"][1:])
    six_n = 6 * cfg.param_count() * tokens
    share = walk["flops"] / (step_ms / 1e3) / PEAK_OPS_PER_S["bfloat16"]
    log(f"[dryrun] the step's traced FLOPs {walk['flops']:.4e} ({walk['flops'] / six_n:.3f}x 6*N*tokens = "
        f"{six_n:.4e}, N = {cfg.param_count()}, {tokens} tokens); at the measured median step of {step_ms:.2f} ms "
        f"that is {share * 100:.2f}% of the {PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s bf16 dense peak; "
        f"on {card}")
    costs = dispatch_cost(torch)
    for name, t in costs.items():
        log(f"[dryrun] host cost a call, {name}: custom op {t['custom op']} us, wrapper {t['wrapper']} us "
            f"(turns: wrapper, op, op, wrapper); on {card}")
    if abs(ratio - 1) > DRYRUN_RTOL:
        raise AssertionError(f"dryrun: predicted peak {mem['peak_bytes']} B is {ratio:.4f}x the measured "
                             f"{measured:.0f} B, beyond {DRYRUN_RTOL}")
    return {"trace_s": trace_s, "argument_bytes": mem["argument_size_in_bytes"], "peak_bytes": mem["peak_bytes"],
            "temp_bytes": mem["temp_size_in_bytes"], "measured_peak_bytes": measured, "ratio": ratio,
            "flops": walk["flops"], "bytes": walk["bytes"], "six_n_tokens": six_n, "step_ms": step_ms,
            "bf16_peak_share": share, "flops_by_op": rec["flops_by_op"], "dispatch_us": costs}


def expected_pod_launches(cfg, options, pods: int, rank: int):
    """Launches of one pod's train step: ``expected_train_launches``, and the
    hop kernel as ``collectives.hop_launches`` predicts for each leaf of the
    gradient tree over ``pods`` ranks (the parameters' type with one
    microbatch, the f32 sums with more)."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    size = 4 if options.num_microbatches > 1 else getattr(torch, cfg.param_dtype).itemsize
    method = TS.POD_SYNC_METHODS[options.pod_sync]
    return dict(expected_train_launches(cfg, options), chunk_reduce=sum(
        C.hop_launches(method, pods, rank, math.prod(p.shape) * size, C.HOST_STAGED_CONFIG)
        for p in leaves(T.model_skel(cfg))))


def pods(torch, card: str):
    """The launcher's multi-pod training at full width: qwen3-14b cut to
    POD_LAYERS layers, POD_PODS pods of one row of TRAIN_SEQ tokens each,
    hoplite_chain between them, POD_STEPS steps through
    ``launch.train.run(pods=...)``.  First one process takes one step on the
    joined batch, and is freed.  The pods' replicas must hash the same after
    every step (``run`` raises if not), their first loss and gradient norm
    equal the one process's within POD_RTOL, and each pod's launches per step
    equal ``expected_pod_launches``.  It reckons the card memory the pods
    need before they start and fails if it does not fit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.planner import HOST_STAGED_LINK
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    full = get_config(ARCH)
    cfg = dataclasses.replace(full, num_layers=POD_LAYERS)
    shape = ShapeSpec("train_4k, batch cut", TRAIN_SEQ, POD_BATCH, "train")
    opts = TS.TrainOptions(num_microbatches=1, remat="full", pod_sync="hoplite_chain")
    n = cfg.param_count()
    pbytes = getattr(torch, cfg.param_dtype).itemsize
    state_b, grad_b = n * (pbytes + 8), n * pbytes  # bf16 parameters, f32 m and v; bf16 gradients
    rows = POD_BATCH // POD_PODS
    logits_b = rows * TRAIN_SEQ * cfg.padded_vocab * 4
    embed_b = cfg.padded_vocab * cfg.d_model * 4
    # AdamW's f32 passes over the largest leaf (the gradient scaled, a moment
    # term, the step's two quotients) against the loss's f32 logits, their
    # exponentials and their gradient: the larger is a pod's transient peak
    transient_b = max(4 * embed_b, 3 * logits_b)
    need = POD_PODS * (state_b + grad_b + transient_b)
    free, total = torch.cuda.mem_get_info()
    log(f"[pods] {cfg.name} at full width (d={cfg.d_model}, {cfg.num_heads} q / {cfg.num_kv_heads} kv heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}), cut to {POD_LAYERS} of {full.num_layers} layers: {n / 1e9:.3f} B "
        f"parameters; {POD_PODS} pods, each a rank process with a replica on the one card, {rows} row of "
        f"{TRAIN_SEQ} tokens a pod, one microbatch, remat {opts.remat}, {opts.pod_sync}, {POD_STEPS} steps")
    log(f"[pods] reckoned per pod: state {state_b / 1e9:.2f} GB, {cfg.param_dtype} gradients {grad_b / 1e9:.2f} "
        f"GB (the sync's volume a step), transients up to {transient_b / 1e9:.2f} GB (f32 logits "
        f"{logits_b / 1e9:.2f} GB; the embedding in f32 {embed_b / 1e9:.2f} GB): {POD_PODS} pods "
        f"{need / 1e9:.2f} GB; the card has {free / 1e9:.2f} of {total / 1e9:.2f} GB free; host memory available "
        f"{mem_available_bytes() / 1e9:.1f} GB")
    if need > free:
        raise AssertionError(f"pods: {POD_PODS} replicas need about {need / 1e9:.2f} GB; {free / 1e9:.2f} GB free")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, one = LT.run(cfg, shape, opts, "cuda", steps=1, seed=SEED, log_every=1,
                        log=lambda m: log(f"[pods] one process on the joined batch: {m}"))
    one_peak = torch.cuda.max_memory_allocated()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pods] one process: {time.perf_counter() - t0:.1f} s, peak {one_peak / 1e9:.2f} GB; freed "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated); host memory available "
        f"{mem_available_bytes() / 1e9:.1f} GB before the pods")

    t0 = time.perf_counter()
    _, recs = LT.run(cfg, shape, opts, "cuda", steps=POD_STEPS, seed=SEED, log_every=1,
                     log=lambda m: log(f"[pods] {m}"), pods=POD_PODS, return_state=False)  # the main path
    phase_s = time.perf_counter() - t0
    want = [expected_pod_launches(cfg, opts, POD_PODS, r) for r in range(POD_PODS)]
    grad_sizes = [math.prod(p.shape) * pbytes for p in leaves(T.model_skel(cfg))]
    predicted_ms = sum(HOST_STAGED_LINK.transfer_time(b) for b in grad_sizes) * 1e3
    for r in recs:
        log(f"[pods] step {r['step']}: loss {r['loss']!r} gnorm {r['grad_norm']!r}; digests {r['digests']}; "
            + "; ".join(f"pod {i}: {p['ms']:.1f} ms = own {p['ms'] - p['sync_ms']:.1f} + sync {p['sync_ms']:.1f} "
                        f"(predicted {predicted_ms:.1f}), peak {p['peak_bytes'] / 1e9:.2f} GB, launches "
                        f"{p['launches']}" for i, p in enumerate(r["pods"])))
    rel = {k: abs(recs[0][k] - one[0][k]) / abs(one[0][k]) for k in ("loss", "grad_norm")}
    log(f"[pods] first step against one process on the joined batch: loss {recs[0]['loss']!r} vs "
        f"{one[0]['loss']!r}, gnorm {recs[0]['grad_norm']!r} vs {one[0]['grad_norm']!r}; relative {rel} "
        f"(tol {POD_RTOL:g}); phase {phase_s:.1f} s")
    if len(recs) != POD_STEPS or any(len(set(r["digests"])) != 1 for r in recs):
        raise AssertionError(f"pods: {len(recs)} steps, digests {[r['digests'] for r in recs]}")
    if any(v > POD_RTOL for v in rel.values()):
        raise AssertionError(f"pods: the first step differs from one process on the joined batch by {rel}")
    got = [[r["pods"][i]["launches"] for r in recs] for i in range(POD_PODS)]
    if any(g != want[i] for i in range(POD_PODS) for g in got[i]):
        raise AssertionError(f"pods: launches {got}, expected {want} a step")
    counts = {k: sum(g[k] for pod in got for g in pod) for k in want[0]}
    ms = [[r["pods"][i]["ms"] for r in recs] for i in range(POD_PODS)]
    sync_ms = [[r["pods"][i]["sync_ms"] for r in recs] for i in range(POD_PODS)]
    return counts, {"layers": POD_LAYERS, "pods": POD_PODS, "rows_per_pod": rows, "seq": TRAIN_SEQ,
                    "params": n, "state_gb": state_b / 1e9, "grad_gb": grad_b / 1e9, "need_gb": need / 1e9,
                    "free_gb": free / 1e9, "one_process_peak_gb": one_peak / 1e9,
                    "loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs],
                    "one_process": {"loss": one[0]["loss"], "grad_norm": one[0]["grad_norm"], "ms": one[0]["ms"]},
                    "first_step_rel": rel, "step_ms": ms, "sync_ms": sync_ms,
                    "own_ms": [[a - b for a, b in zip(x, y)] for x, y in zip(ms, sync_ms)],
                    "sync_predicted_ms": predicted_ms,
                    "peak_gb": [recs[-1]["pods"][i]["peak_bytes"] / 1e9 for i in range(POD_PODS)],
                    "digests": [r["digests"] for r in recs], "phase_s": phase_s}


# The mesh phase: the launchers over the debug mesh, MESH_RANKS rank processes
# on the one card.  Train: qwen3-14b's layer widths with its vocabulary cut to
# MESH_VOCAB: at 151,936 the embedding, split over the model axis only, holds
# 3.89 GB of bf16 weights and f32 moments a rank, and 8 ranks run out of the
# card at 1 layer in 1 microbatch on either mesh (chip_mesh_fit.py).
# MESH_BATCH rows of MESH_SEQ tokens (one row a data shard) in MESH_MICRO
# microbatches, full remat, MESH_STEPS steps: MESH_LAYERS on (data 4, model 2),
# MESH_POD_LAYERS on (pod 2, data 2, model 2).  Serve: qwen3-14b at full width
# cut to MESH_SERVE_LAYERS on (data 4, model 2), MESH_SERVE (batch, prompt,
# greedy tokens, max_seq).
MESH_VOCAB, MESH_LAYERS, MESH_POD_LAYERS = 32768, 2, 2
MESH_SEQ, MESH_BATCH, MESH_MICRO, MESH_STEPS = 2048, 4, 2, 2
MESH_SERVE_LAYERS, MESH_SERVE = 4, (4, 512, 4, 1024)
MESH_RANKS = 8
# Each rank's max_memory_allocated against the dry run's prediction for its
# device (as DRYRUN_RTOL); the mesh's loss and gradient norm against one
# process's, relative (f32 partial sums in another order: 3e-7 to 2.8e-5 on
# an H100); its logits against one process's, relative L2 (bf16: the tests'
# bf16 tolerance).
MESH_MEM_RTOL = 0.10
MESH_RTOL = 1e-4
# The parameters after the last step against one process's: MESH_SAMPLES
# elements of each leaf (``launch.train.param_samples``), each leaf's update
# (final - initial) within MESH_UPDATE_RTOL of one process's in relative L2.
# The weights are bf16, and at the warmup's lr (6e-6, 9e-6) most updates
# round away; an element whose update lies near half an ulp rounds one way
# on the mesh and the other in one process, which puts the gap at
# 0.011-0.131 (on an H100).  A mesh that skipped or reversed the update is at 1 or 2.
MESH_SAMPLES = 1 << 18
MESH_UPDATE_RTOL = 0.25
# A rank's CUDA context and torch's own allocations outside its tensors: what
# the card had in use beside 8 ranks' reserved memory when they ran out of
# it, about 1.6 GB a rank (chip_mesh_fit.py on an H100).
MESH_CONTEXT_BYTES = 1.6e9
MESH_LOGITS_TOL = 2e-2


def mesh_peak_prediction(torch, cfg, shape, options, multi_pod: bool = False) -> int:
    """The dry run's peak bytes per device for one train step of ``cfg`` on
    the debug mesh (``launch.dryrun.build_cell`` and ``trace_cell`` on
    ``fake_mesh(debug=True)`` with fake ``cuda`` tensors, rank 0's view;
    every split here is even, so each rank's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_mesh

    make = lambda shape_, dtype: torch.empty(shape_, dtype=dtype, device="cuda")
    with fake_mesh(multi_pod=multi_pod, debug=True, device="cuda") as fmesh, FakeTensorMode():
        fn, args = DR.build_cell(cfg, shape, fmesh, options.pod_sync, make=make,
                                 microbatches=options.num_microbatches)
        rec = DR.trace_cell(fn, args)
    return rec["memory"]["peak_bytes"]


def mesh_serve_prediction(torch, cfg, batch: int, prompt: int, max_seq: int) -> int:
    """The dry run's peak bytes per device of ``cfg``'s prefill of ``batch`` x
    ``prompt`` tokens into caches of ``max_seq`` on the (4, 2) debug mesh
    (fake ``cuda`` tensors, as ``mesh_peak_prediction``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models import transformer as T

    make = lambda shape_, dtype: torch.empty(shape_, dtype=dtype, device="cuda")
    with DR._variant_restored(), fake_mesh(debug=True, device="cuda") as fmesh, FakeTensorMode():
        _, args = DR.build_cell(cfg, ShapeSpec("mesh serve", prompt, batch, "prefill"), fmesh, "gspmd", make=make)
        rec = DR.trace_cell(lambda params, inputs: T.prefill(cfg, params, inputs, cache_seq=max_seq), args)
    return rec["memory"]["peak_bytes"]


def expected_mesh_pod_launches(cfg, options, rank: int):
    """One rank's launches of a train step on (pod 2, data 2, model 2) under a
    Hoplite pod sync: ``expected_train_launches``, and the hop kernel as
    ``collectives.hop_launches`` predicts for each leaf's local block on the
    pod's (data, model) sub-mesh, over the 2 pods (the f32 sums with more
    than one microbatch, else the parameters' type)."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.launch.mesh import debug_mesh_shape
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partitioning, placement
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    mesh = debug_mesh_shape(multi_pod=True)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    pods, pod = sizes["pod"], rank // (sizes["data"] * sizes["model"])
    size = 4 if options.num_microbatches > 1 else getattr(torch, cfg.param_dtype).itemsize
    specs = [s.spec for s in leaves(placement.spec_leaves(
        partitioning.param_specs(cfg, T.model_skel(cfg), mesh, options.sharding)))]
    hops = 0
    for p, spec in zip(leaves(T.model_skel(cfg)), specs):
        split = math.prod(sizes[a] for entry in spec for a in ((entry,) if isinstance(entry, str) else entry or ()))
        hops += C.hop_launches(TS.POD_SYNC_METHODS[options.pod_sync], pods, pod,
                               math.prod(p.shape) // split * size, C.HOST_STAGED_CONFIG)
    return dict(expected_train_launches(cfg, options), chunk_reduce=hops)


def _collectives_line(ranks) -> str:
    """Each kind's calls, GB and seconds, summed over the ranks' records."""
    total = {}
    for r in ranks:
        for kind, c in r["collectives"].items():
            t = total.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
            for k in t:
                t[k] += c[k]
    return "; ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.3f} GB {v['seconds']:.2f} s"
                     for k, v in sorted(total.items()))


def mesh_fits(torch, per_rank: int, what: str) -> None:
    """Fail unless the card has room for MESH_RANKS ranks of ``per_rank``
    bytes each (the dry run's peak) and their CUDA contexts
    (MESH_CONTEXT_BYTES each)."""
    free, total = torch.cuda.mem_get_info()
    need = MESH_RANKS * (per_rank + MESH_CONTEXT_BYTES)
    log(f"[mesh] {what}: {MESH_RANKS} ranks need about {need / 1e9:.2f} GB ({per_rank / 1e9:.3f} GB predicted a "
        f"rank, {MESH_CONTEXT_BYTES / 1e9:.1f} GB a context); the card has {free / 1e9:.2f} of {total / 1e9:.2f} "
        f"GB free, this process {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    if need > free:
        raise AssertionError(f"mesh {what}: {MESH_RANKS} ranks need about {need / 1e9:.2f} GB; {free / 1e9:.2f} free")


def update_gaps(init, got, want) -> dict:
    """Each leaf's update in ``got`` (final - ``init``) against ``want``'s, in
    relative L2 over the sampled elements (``launch.train.param_samples``);
    raises if ``want`` did not move a sampled element of a leaf."""
    import numpy as np

    gaps = {}
    for name, p0 in init.items():
        du, dw = got[name] - p0, want[name] - p0
        if not np.abs(dw).max() > 0:
            raise AssertionError(f"{name}: one process's update moved none of {p0.size} sampled elements")
        gaps[name] = float(np.linalg.norm(du - dw) / np.linalg.norm(dw))
    return gaps


def mesh_train(torch, card: str, cfg, layers: int, micro: int, multi_pod: bool, syncs, add) -> dict:
    """``launch.train.run`` on the debug mesh (with ``multi_pod``, (pod 2,
    data 2, model 2)) for each pod sync of ``syncs``, after one process took
    the same steps on the card; each rank's launches a step, peak against
    the dry run's prediction, the metrics and the sampled parameters'
    updates against one process's.  ``add`` takes each rank's launches.
    Returns the metrics by sync."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as LT
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeSpec("mesh train", MESH_SEQ, MESH_BATCH, "train")
    where = "(pod 2, data 2, model 2)" if multi_pod else "(data 4, model 2)"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, SEED, "cuda")
    init = LT.param_samples(state["params"], MESH_SAMPLES, SEED)
    del state
    one_opts = TS.TrainOptions(num_microbatches=micro, remat="full", pod_sync="gspmd")
    state, one = LT.run(cfg, shape, one_opts, "cuda", steps=MESH_STEPS, seed=SEED, log_every=MESH_STEPS,
                        log=lambda _: None, samples=MESH_SAMPLES)
    del state  # the ranks need the card
    log(f"[mesh] {cfg.name}, {layers} layers, one process on the card: {time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"step {r['step']} loss {r['loss']!r} gnorm {r['grad_norm']!r} {r['ms']:.1f} ms" for r in one)
        + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for sync in syncs:
        opts = TS.TrainOptions(num_microbatches=micro, remat="full", pod_sync=sync)
        t0 = time.perf_counter()
        pred = mesh_peak_prediction(torch, cfg, shape, opts, multi_pod)
        trace_s = time.perf_counter() - t0
        mesh_fits(torch, pred, f"{where} {sync}")
        t0 = time.perf_counter()
        _, recs = LT.run(cfg, shape, opts, "cuda", steps=MESH_STEPS, seed=SEED, log_every=1,
                         log=lambda m: log(f"[mesh] {sync} rank 0: {m}"), mesh=LT.mesh_for(MESH_RANKS, multi_pod),
                         return_state=False, samples=MESH_SAMPLES)  # the main path: launch/train.py --devices 8
        run_s = time.perf_counter() - t0
        want = [expected_mesh_pod_launches(cfg, opts, i) if multi_pod and sync != "gspmd"
                else expected_train_launches(cfg, opts) for i in range(MESH_RANKS)]
        for r in recs:
            log(f"[mesh] {where} {sync}, step {r['step']}: loss {r['loss']!r} gnorm {r['grad_norm']!r}, "
                f"{r['ms']:.1f} ms on rank 0; the staged collectives, summed over the ranks: "
                f"{_collectives_line(r['ranks'])}")
            for i, rank in enumerate(r["ranks"]):
                sync_ms = f" (the pods' sync {rank['sync_ms']:.1f} ms)" if "sync_ms" in rank else ""
                log(f"[mesh] {sync} step {r['step']} rank {i}: {rank['ms']:.1f} ms{sync_ms}, launches "
                    f"{rank['launches']} (expected {want[i]}), max_memory_allocated {rank['peak_bytes'] / 1e9:.3f} GB")
                add(rank["launches"])
        peaks = [rank["peak_bytes"] for rank in recs[-1]["ranks"]]
        ratio = [p / pred for p in peaks]
        rel = {k: [abs(r[k] - o[k]) / abs(o[k]) for r, o in zip(recs, one)] for k in ("loss", "grad_norm")}
        hops = [sum(r["ranks"][i]["launches"]["chunk_reduce"] for r in recs) for i in range(MESH_RANKS)]
        gaps = update_gaps(init, recs[-1]["param_samples"], one[-1]["param_samples"])
        log(f"[mesh] {cfg.name}, vocabulary {cfg.vocab_size}, {layers} layers, {micro} microbatch(es), {where}, {sync}: "
            f"{run_s:.1f} s with the ranks' start; each rank's max_memory_allocated over the dry run's "
            f"{pred / 1e9:.3f} GB (traced in {trace_s:.1f} s): {', '.join(f'{x:.4f}' for x in ratio)} (tol "
            f"{MESH_MEM_RTOL}), {sum(peaks) / 1e9:.2f} GB summed; against one process, relative: {rel} (tol "
            f"{MESH_RTOL}); each leaf's update over {MESH_SAMPLES} sampled elements against one process's, relative "
            f"L2: {gaps} (tol {MESH_UPDATE_RTOL}); chunk_reduce launches per rank {hops}; on {card}")
        if any(r["ranks"][i]["launches"] != want[i] for r in recs for i in range(MESH_RANKS)):
            raise AssertionError(f"mesh {sync}: launches {[[k['launches'] for k in r['ranks']] for r in recs]}, "
                                 f"expected {want}")
        if any(abs(x - 1) > MESH_MEM_RTOL for x in ratio):
            raise AssertionError(f"mesh {sync}: peaks {peaks} against the prediction {pred}: {ratio}")
        if any(v > MESH_RTOL for vals in rel.values() for v in vals):
            raise AssertionError(f"mesh {sync}: the metrics differ from one process's by {rel}")
        if any(not g <= MESH_UPDATE_RTOL for g in gaps.values()):
            raise AssertionError(f"mesh {sync}: the parameters' updates differ from one process's by {gaps}")
        out[sync] = {"layers": layers, "microbatches": micro, "update_gaps": gaps, "predicted_peak_bytes": pred, "peak_bytes": peaks, "peak_ratio": ratio,
                     "loss": [r["loss"] for r in recs], "grad_norm": [r["grad_norm"] for r in recs], "rel": rel,
                     "one_process": {"loss": [r["loss"] for r in one], "grad_norm": [r["grad_norm"] for r in one],
                                     "ms": [r["ms"] for r in one]},
                     "step_ms": [[k["ms"] for k in r["ranks"]] for r in recs],
                     "sync_ms": [[k.get("sync_ms") for k in r["ranks"]] for r in recs],
                     "collectives_rank0": [r["ranks"][0]["collectives"] for r in recs], "chunk_reduce": hops,
                     "run_s": run_s, "trace_s": trace_s}
    return out


def mesh(torch, card: str):
    """The launchers over the debug mesh, as ``--devices 8``: MESH_RANKS rank
    processes share the card and exchange through the staged backend.

    Train (``mesh_train``): qwen3-14b's layer widths with the vocabulary cut
    to MESH_VOCAB, depth cut, on (data 4, model 2) and on (pod 2, data 2, model 2) under ``hoplite_chain`` (each
    rank's ``chunk_reduce`` launches as ``expected_mesh_pod_launches``;
    ``run`` fails unless the pods' blocks are bit for bit the same after
    every step) and ``gspmd``.  Each rank's launches a step are predicted,
    its ``max_memory_allocated`` held within MESH_MEM_RTOL of the dry run's
    prediction, the losses and gradient norms within MESH_RTOL of one
    process's, each parameter's sampled update within MESH_UPDATE_RTOL.  Serve: ``launch.serve.serve(devices=
    8)`` on qwen3-14b at full width cut to MESH_SERVE_LAYERS, each rank's
    launches as ``expected_launches``, its peak against the dry run's
    prefill, the logits within MESH_LOGITS_TOL of one process's (relative
    L2) and the first tokens equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.serving.engine import ServeOptions

    t_phase = time.perf_counter()
    full = get_config(ARCH)
    counts = {"rmsnorm": 0, "flash_attention_tc": 0, "flash_attention_f32": 0, "chunk_reduce": 0, "dequant_add": 0}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    cut = dataclasses.replace(full, vocab_size=MESH_VOCAB)
    log(f"[mesh] train: {ARCH}'s layer widths (d={full.d_model}, {full.num_heads} q / {full.num_kv_heads} kv heads, "
        f"head dim {full.head_dim}, d_ff {full.d_ff}), vocabulary cut from {full.vocab_size} to {MESH_VOCAB}, "
        f"{MESH_BATCH} x {MESH_SEQ} tokens in {MESH_MICRO} microbatches, full remat, {MESH_STEPS} steps, "
        f"{MESH_RANKS} rank processes on the one card")
    train = mesh_train(torch, card, cut, MESH_LAYERS, MESH_MICRO, False, ("gspmd",), add)
    pods = mesh_train(torch, card, cut, MESH_POD_LAYERS, MESH_MICRO, True, ("hoplite_chain", "gspmd"), add)

    bsz, prompt, new, max_seq = MESH_SERVE
    scfg = dataclasses.replace(full, num_layers=MESH_SERVE_LAYERS)
    host = LS.random_batch(scfg, bsz, prompt, SEED)
    sopts = ServeOptions(max_seq=max_seq, batch_size=bsz)
    pred = mesh_serve_prediction(torch, scfg, bsz, prompt, max_seq)
    gc.collect()
    torch.cuda.empty_cache()
    (toks1, logits1), one_s, _ = LS.serve(scfg, "cuda", SEED, sopts, host, new, return_logits=True)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_fits(torch, pred, "serve")
    t0 = time.perf_counter()
    (toks, logits), gen_s, sranks = LS.serve(scfg, "cuda", SEED, sopts, host, new, devices=MESH_RANKS,
                                             return_logits=True)  # the main path: launch/serve.py --devices 8
    serve_s = time.perf_counter() - t0
    want = expected_launches(scfg, new - 1)
    rel_l2 = float(((logits - logits1) ** 2).sum() ** 0.5 / (logits1 ** 2).sum() ** 0.5)
    max_abs = float(abs(logits - logits1).max() / abs(logits1).max())
    ratio = [r["peak_bytes"] / pred for r in sranks]
    for i, r in enumerate(sranks):
        log(f"[mesh] serve rank {i}: generate {r['seconds']:.2f} s, launches {r['launches']} (expected {want}), "
            f"max_memory_allocated {r['peak_bytes'] / 1e9:.3f} GB ({ratio[i]:.4f}x the dry run's prefill)")
        add(r["launches"])
    log(f"[mesh] serve {scfg.name} at full width, {MESH_SERVE_LAYERS} of {full.num_layers} layers, {bsz} x {prompt} "
        f"tokens and {new} greedy tokens on (data 4, model 2): generate {gen_s:.2f} s (one process {one_s:.2f} s; "
        f"{serve_s:.1f} s with the ranks' start); the dry run's prefill {pred / 1e9:.3f} GB a rank; logits against "
        f"one process's: relative L2 {rel_l2:.3e} (tol {MESH_LOGITS_TOL}), max abs {max_abs:.3e} of the largest; "
        f"tokens equal {int((toks == toks1).sum())} of {toks.size}; staged collectives: {_collectives_line(sranks)}; "
        f"on {card}")
    if any(r["launches"] != want for r in sranks):
        raise AssertionError(f"mesh serve: launches {[r['launches'] for r in sranks]}, expected {want}")
    if not rel_l2 <= MESH_LOGITS_TOL or toks.shape != (bsz, new) or not (toks[:, 0] == toks1[:, 0]).all():
        raise AssertionError(f"mesh serve: logits {rel_l2} from one process's, tokens {toks[:, 0]} {toks1[:, 0]}")
    if any(abs(x - 1) > MESH_MEM_RTOL for x in ratio):
        raise AssertionError(f"mesh serve: peaks {[r['peak_bytes'] for r in sranks]} against {pred}: {ratio}")
    phase_s = time.perf_counter() - t_phase
    log(f"[mesh] phase {phase_s:.1f} s; launches over the ranks {counts}")
    return counts, {"vocab": MESH_VOCAB, "seq": MESH_SEQ, "batch": MESH_BATCH, "microbatches": MESH_MICRO,
                    "train": train, "pods": pods,
                    "serve": {"layers": MESH_SERVE_LAYERS, "generate_s": gen_s, "one_process_s": one_s,
                              "predicted_peak_bytes": pred, "peak_bytes": [r["peak_bytes"] for r in sranks],
                              "logits_rel_l2": rel_l2, "logits_max_abs": max_abs,
                              "collectives": [r["collectives"] for r in sranks]},
                    "phase_s": phase_s}


def mem_available_bytes() -> int:
    """The host memory the kernel says is available (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def same_bits(torch, a, b) -> bool:
    """Two tensors of one type and shape with the same bits (bf16 included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


def timed_step(torch, train_step, state, batch):
    """One train step as ``launch.train.run`` times it: from a synchronised
    card to the metrics on the host.  Returns (state, metrics, ms)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = train_step(state, batch)
    metrics = {k: float(v) for k, v in m.items()}
    return state, metrics, (time.perf_counter() - t) * 1e3


def launcher_restart_on_the_card(torch, tmp: Path):
    """``launch.train`` restarting from a checkpoint directory on the card,
    on reduced qwen3-14b in bf16 (a state of a few MB): 4 steps with a
    checkpoint every 2, then a new run to step 6, against an uninterrupted
    6-step run; the resumed losses and gradient norms must be its own bit for
    bit.  Returns the resumed run's (loss, grad_norm) per step."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as LT
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype="bfloat16", param_dtype="bfloat16")
    shape, opts = ShapeSpec("t", 64, 4, "train"), TS.TrainOptions(num_microbatches=2)
    run = lambda steps, d, logs, every: LT.run(cfg, shape, opts, "cuda", steps=steps, seed=SEED, log_every=100,
                                               log=logs.append, ckpt_dir=str(d), ckpt_every=every)[1]
    logs = []
    whole = run(6, tmp / "whole", [], 100)
    run(4, tmp / "cut", [], 2)
    resumed = run(6, tmp / "cut", logs, 2)
    got = [(r["loss"], r["grad_norm"]) for r in resumed]
    want = [(r["loss"], r["grad_norm"]) for r in whole[4:]]
    log(f"[ckpt] launch.train on {cfg.name} (bf16) on the card: {logs[0]!r}; resumed steps "
        f"{[r['step'] for r in resumed]}: (loss, gnorm) {got}, uninterrupted {want}")
    if logs[0] != "[restart] resumed from checkpoint step 4" or got != want:
        raise AssertionError(f"ckpt: the launcher's restart on the card: {logs}, {got} against {want}")
    return got


def ckpt(torch, card: str):
    """Checkpoint and restart of the train phase's state (see the module's
    docstring).  It writes one checkpoint of this state, asynchronously,
    while the uninterrupted run steps on, and restarts from it: a run of the
    script writes about 29 GB to disk, not a multiple of it.  Where a host
    caps the bytes one job may write (deleted files count), a cap of 45 GiB
    holds one run of the script and about 16 GB of other writes, not two
    runs.  Returns the launches of the phase's train steps and its
    metrics."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k, batch cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    opts = TS.TrainOptions(num_microbatches=TRAIN_MICRO, remat="full", pod_sync="gspmd")
    want = expected_train_launches(cfg, opts)
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(TS.abstract_state(cfg)))
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)  # a run that died left it
    root.parent.mkdir(parents=True, exist_ok=True)
    disk, mem = shutil.disk_usage(root.parent).free, mem_available_bytes()
    need_disk, need_mem = state_bytes + CKPT_SPARE_BYTES, 2 * state_bytes + CKPT_SPARE_BYTES
    log(f"[ckpt] state {state_bytes / 1e9:.2f} GB ({cfg.name}, {TRAIN_LAYERS} layers: {cfg.param_dtype} parameters, "
        f"f32 moments, int32 counts); free disk under {root.parent}: {disk / 1e9:.1f} GB (need "
        f"{need_disk / 1e9:.1f}: one checkpoint); host memory available {mem / 1e9:.1f} GB (need "
        f"{need_mem / 1e9:.1f}: the phase's own copy, and the checkpointer's, which the written files replace "
        "leaf by leaf where the file system keeps them in memory)")
    if disk < need_disk or mem < need_mem:
        raise AssertionError(f"ckpt: {disk / 1e9:.1f} GB of disk and {mem / 1e9:.1f} GB of host memory cannot "
                             f"hold the phase's {need_disk / 1e9:.1f} and {need_mem / 1e9:.1f} GB")
    dev = torch.device("cuda")
    batch = lambda i: pipeline.device_batch(cfg, shape, i, dev, SEED)
    train_step = TS.make_train_step(cfg, opts)
    try:
        # The run up to the save, through the launcher.
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, recs = LT.run(cfg, shape, opts, "cuda", steps=CKPT_SAVE_AT, seed=SEED, log_every=100,
                             log=lambda m: None)  # the main path
        log(f"[ckpt] {CKPT_SAVE_AT} steps through launch.train.run in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"step {r['step']} loss {r['loss']!r} {r['ms']:.1f} ms" for r in recs))
        # The phase's own copy of the state as saved, to hold the restored one to.
        t0 = time.perf_counter()
        saved = [t.to("cpu", copy=True) for t in leaves(state)]
        copy_s = time.perf_counter() - t0

        # The save: the copy to host memory now, the write on a thread while the run steps on.
        ck = Checkpointer(str(root), keep=1)
        ck.save_async(CKPT_SAVE_AT, state)
        whole, during, after, i = [], [], [], CKPT_SAVE_AT
        while True:  # each step here starts while the write runs
            state, m, ms = timed_step(torch, train_step, state, batch(i))
            whole.append(m)
            during.append(ms)
            i += 1
            if not ck.in_flight() or len(during) == CKPT_MAX_DURING:
                break
        t0 = time.perf_counter()
        ck.wait()
        waited_s = time.perf_counter() - t0
        while len(after) < CKPT_AFTER or len(whole) < CKPT_RESUMED:
            state, m, ms = timed_step(torch, train_step, state, batch(i))
            whole.append(m)
            after.append(ms)
            i += 1
        save = ck.history[-1]
        before = [r["ms"] for r in recs[1:]]
        steps = {"before": before, "during": during, "after": after}
        stats = {k: (statistics.median(v), max(v)) for k, v in steps.items()}
        log(f"[ckpt] async save of step {CKPT_SAVE_AT}: {save['bytes'] / 1e9:.2f} GB in {len(saved)} leaves; copy to "
            f"host memory (save_async's synchronous part) {save['snapshot_s'] * 1e3:.1f} ms "
            f"({save['bytes'] / save['snapshot_s'] / 1e9:.3f} GB/s); write on the thread {save['write_s']:.2f} s "
            f"({save['bytes'] / save['write_s'] / 1e9:.3f} GB/s), {waited_s:.2f} s of it left after the steps; "
            f"{len(during)} steps started during the write ({sum(during) / 1e3:.2f} s); step ms (median, max) "
            + ", ".join(f"{k} {len(v)} steps ({stats[k][0]:.1f}, {stats[k][1]:.1f})" for k, v in steps.items())
            + f"; during / before: median {stats['during'][0] / stats['before'][0]:.4f}x, max "
            f"{stats['during'][1] / stats['before'][1]:.4f}x; after / before: median "
            f"{stats['after'][0] / stats['before'][0]:.4f}x; the phase's own copy {copy_s:.2f} s; host memory "
            f"available {mem_available_bytes() / 1e9:.1f} GB; on {card}")
        log(f"[ckpt] step ms during the write: {[round(x, 1) for x in during]}")
        if ck.list_steps() != [CKPT_SAVE_AT]:
            raise AssertionError(f"ckpt: the directory holds steps {ck.list_steps()}")
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # Restore onto the card: the state as saved, bit for bit; then resume.
        step, state = ck.restore(TS.abstract_state(cfg), device="cuda")
        torch.cuda.synchronize()
        rec = ck.history[-1]
        equal = [same_bits(torch, a, w.to(dev)) for a, w in zip(leaves(state), saved)]
        del saved
        log(f"[ckpt] restore of step {step} onto the card: {rec['bytes'] / 1e9:.2f} GB in {rec['restore_s']:.2f} s "
            f"({rec['bytes'] / rec['restore_s'] / 1e9:.3f} GB/s; reading the files {rec['read_s']:.2f} s, "
            f"{rec['bytes'] / rec['read_s'] / 1e9:.3f} GB/s; the copies to the card the rest); {sum(equal)} of "
            f"{len(equal)} leaves equal the state as saved bit for bit")
        if step != CKPT_SAVE_AT or not all(equal):
            raise AssertionError(f"ckpt: step {step}, leaves equal {equal}")
        resumed = []
        for i in range(CKPT_SAVE_AT, CKPT_SAVE_AT + CKPT_RESUMED):
            state, m, _ = timed_step(torch, train_step, state, batch(i))
            resumed.append(m)
        del state
        counts = ops.launch_counts()
        n_steps = CKPT_SAVE_AT + len(whole) + len(resumed)
        whole = whole[:CKPT_RESUMED]
        diffs = [{k: abs(r[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")} for r, w in zip(resumed, whole)]
        log("[ckpt] resumed against uninterrupted: " + "; ".join(
            f"step {CKPT_SAVE_AT + 1 + i} loss {r['loss']!r} vs {w['loss']!r}, gnorm {r['grad_norm']!r} vs "
            f"{w['grad_norm']!r}" for i, (r, w) in enumerate(zip(resumed, whole))) + f" (tol {CKPT_RTOL:g} after the "
            "first)")
        if resumed[0]["loss"] != whole[0]["loss"]:
            raise AssertionError(f"ckpt: the first resumed loss {resumed[0]['loss']!r} is not the uninterrupted "
                                 f"{whole[0]['loss']!r}")
        if any(d > CKPT_RTOL for row in diffs for d in row.values()):
            raise AssertionError(f"ckpt: resumed steps differ from the uninterrupted ones by {diffs}")
        if counts != {k: n_steps * n for k, n in want.items()}:
            raise AssertionError(f"ckpt: {n_steps} steps launched {counts}, expected {want} a step")
        gc.collect()
        torch.cuda.empty_cache()
        launcher = launcher_restart_on_the_card(torch, root / "launcher")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if root.exists():
        raise AssertionError(f"ckpt: {root} was not removed")
    log(f"[ckpt] {root} removed")
    return counts, {"state_gb": state_bytes / 1e9, "disk_free_gb": disk / 1e9, "mem_available_gb": mem / 1e9,
                    "snapshot_ms": save["snapshot_s"] * 1e3, "snapshot_GBps": save["bytes"] / save["snapshot_s"] / 1e9,
                    "write_s": save["write_s"], "write_GBps": save["bytes"] / save["write_s"] / 1e9,
                    "write_left_after_steps_s": waited_s, "step_ms_before": before, "step_ms_during_write": during,
                    "step_ms_after_write": after,
                    "step_ms_median_max": {k: list(v) for k, v in stats.items()},
                    "restore_s": rec["restore_s"], "restore_read_s": rec["read_s"],
                    "restore_GBps": rec["bytes"] / rec["restore_s"] / 1e9,
                    "loss_uninterrupted": [w["loss"] for w in whole], "loss_resumed": [r["loss"] for r in resumed],
                    "grad_norm_uninterrupted": [w["grad_norm"] for w in whole],
                    "grad_norm_resumed": [r["grad_norm"] for r in resumed], "resumed_rel_diff": diffs,
                    "launcher_restart_reduced": launcher}


def device_events(torch, fn):
    """One call of ``fn`` under torch.profiler: its device-side events
    (kernels, copies), and their total time and count by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    per_name = {}
    for e in events:
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return events, per_name


def busy_ms(events) -> float:
    """The union of the events' intervals, in ms."""
    busy_us, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    return busy_us / 1e3


def device_profile(torch, fn, label: str, wall_ms: float, top: int = 6):
    """Device busy time of one call of ``fn`` by torch.profiler: the union of
    the intervals of its device-side events (kernels, copies), against the
    unprofiled wall time, and the device events that took the most time.
    Returns (busy ms, device ms by kind of EVENT_KINDS)."""
    events, per_name = device_events(torch, fn)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    busy = busy_ms(events)
    log(f"[profile] {label}: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%), {len(events)} device events; top: " + "; ".join(
            f"{name[:60]} {t / 1e3:.2f} ms x{n}" for name, (t, n) in top))
    kinds = {}
    for name, (t, n) in per_name.items():
        kind = next((k for k, keys in EVENT_KINDS if any(key.lower() in name.lower() for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t
    log(f"[profile] {label}: device time by kind: " + "; ".join(
        f"{k} {t / 1e3:.2f} ms ({100 * t / max(1.0, sum(kinds.values())):.1f}%)"
        for k, t in sorted(kinds.items(), key=lambda kv: -kv[1])))
    ours = {k: sum(t for name, (t, _) in per_name.items() if k in name) for k in PORT_KERNELS}
    counts = {k: sum(n for name, (_, n) in per_name.items() if k in name) for k in PORT_KERNELS}
    log(f"[profile] {label}: the port's kernels: " + "; ".join(
        f"{k} {ours[k] / 1e3:.3f} ms x{counts[k]}" for k in PORT_KERNELS))
    return busy, {k: t / 1e3 for k, t in kinds.items()}


# The data plane (core/local.py) on the card: LocalCluster's nodes are host
# threads whose stores all lie on the card.  DP_SIZES are the paper's object
# sizes (benchmarks/common.py:15, PAPER_SIZES: read, not imported), each
# broadcast from node 0 to the other DP_NODES - 1, reduced (one object a
# node) and allreduced in f32 with integer-valued data drawn from SEED, so
# that any arrival order sums them exactly.  A random f32 reduce at
# DP_CHECK_BYTES is held to an f64 sum at DP_RANDOM_RTOL; bf16 and f16
# reduces at DP_CHECK_BYTES hold every fold window's chunk_reduce bit for bit
# to chunk_reduce_ref at the window the data plane gave it.  At
# DP_KILL_BYTES a 1-D chain of DP_NODES - 2 sources is paced (DP_KILL_PACE
# seconds a chunk window) and its tail killed once the target's watermark
# passes half: the reduce must re-splice and stay exact.  The socket backend
# broadcasts and reduces DP_SOCKET_BYTES on DP_SOCKET_NODES nodes.
DP_NODES = 8
DP_SIZES = (1 << 10, 32 << 10, 1 << 20, 32 << 20, 1 << 30)
DP_CHECK_BYTES = 32 << 20
DP_RANDOM_RTOL = 2e-5
DP_KILL_BYTES, DP_KILL_PACE = 1 << 30, 0.002
DP_SOCKET_NODES, DP_SOCKET_BYTES = 4, 32 << 20
DP_UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}


def dp_ints(torch, gen, nbytes: int):
    return torch.randint(-1000, 1000, (nbytes // 4,), generator=gen, device="cuda").float()


def dp_min_folds(c, nbytes: int, sources: int) -> int:
    """The fewest SUM folds a reduce of ``sources`` objects of ``nbytes``
    can take: ``sources - 1`` for each window of the object, windows being
    ``max(chunk, size/16)`` rounded up to 64 bytes (``local._stream_fold``);
    a window splits where an input's watermark lags."""
    from repro_torch.core.local import PIPELINE_MIN_WINDOWS

    cap = max(c.chunk_size_for(nbytes), -(-nbytes // PIPELINE_MIN_WINDOWS))
    cap += (-cap) % 64
    return (sources - 1) * -(-nbytes // cap)


def dp_measure(torch, c, what: str, nbytes: int, moved: int, fn, card: str, min_folds: int = 0) -> dict:
    """Run ``fn`` (one data-plane operation on ``c``) and report: wall ms
    (host clock, the device synchronised after), GB/s (``moved`` bytes over
    the wall time), the windows (copy and fold), the SUM folds the cluster
    counted (``fold_ops``: each one ``chunk_reduce`` launch for f32, bf16 and
    f16, and at least ``min_folds``) against the kernel's launches, and the
    peak memory."""
    from repro_torch.core.api import SUM
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s0 = c.stats
    ops.reset_launch_counts()
    SUM.reset_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s1 = c.stats
    launches = ops.launch_counts()["chunk_reduce"]
    folds = s1["fold_ops"] - s0["fold_ops"]
    rec = {"bytes": nbytes, "wall_ms": wall * 1e3, "GBps": moved / wall / 1e9, "windows": s1["windows"] - s0["windows"],
           "sum_folds": folds, "chunk_reduce": launches, "resplices": s1["resplices"] - s0["resplices"],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[dataplane] {what}: {rec['wall_ms']:.3f} ms, {rec['GBps']:.3f} GB/s ({moved} bytes moved), "
        f"{rec['windows']} windows, SUM folds {folds} (at least {min_folds}) against chunk_reduce launches "
        f"{launches}, max_memory_allocated {rec['peak_bytes'] / 1e9:.3f} GB, on {card}")
    if launches != folds or SUM.counts.get("chunk_reduce", 0) != folds or folds < min_folds:
        raise AssertionError(f"dataplane {what}: {folds} SUM folds, {launches} kernel launches, SUM {SUM.counts}")
    return rec


def dp_paper_sizes(torch, gen, card: str) -> dict:
    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster

    out = {}
    for nbytes in DP_SIZES:
        c = LocalCluster(DP_NODES, device="cuda")
        recv = DP_NODES - 1
        c.put(0, "b", dp_ints(torch, gen, nbytes))

        def bcast():
            for f in [c.prefetch_async(i, "b") for i in range(1, DP_NODES)]:
                f.result(timeout=600)

        rec = {"broadcast": dp_measure(torch, c, f"{nbytes} B f32 broadcast, node 0 to {recv}", nbytes,
                                       recv * nbytes, bcast, card)}
        src = c.get(0, "b")
        for i in range(1, DP_NODES):
            if not torch.equal(c.get(i, "b"), src):
                raise AssertionError(f"dataplane broadcast of {nbytes} B: node {i}'s copy differs")
        c.delete("b")
        ids = [f"g{i}" for i in range(DP_NODES)]
        want = torch.zeros(nbytes // 4, device="cuda")
        for i, oid in enumerate(ids):
            x = dp_ints(torch, gen, nbytes)
            want += x  # integers under 2^24: exact
            c.put(i, oid, x)
            del x
        least = dp_min_folds(c, nbytes, DP_NODES)
        rec["reduce"] = dp_measure(torch, c, f"{nbytes} B f32 reduce of {DP_NODES} into node 0", nbytes,
                                   DP_NODES * nbytes, lambda: c.reduce(0, "r", ids, SUM, timeout=600), card, least)
        if not torch.equal(c.get(0, "r"), want):
            raise AssertionError(f"dataplane reduce of {nbytes} B: not the exact sum")
        c.delete("r")
        nodes = list(range(DP_NODES))
        rec["allreduce"] = dp_measure(torch, c, f"{nbytes} B f32 allreduce over {DP_NODES}", nbytes,
                                      2 * DP_NODES * nbytes,
                                      lambda: c.allreduce(nodes, "ar", ids, SUM, timeout=600), card, least)
        for i in nodes:
            if not torch.equal(c.get(i, "ar"), want):
                raise AssertionError(f"dataplane allreduce of {nbytes} B: node {i} not the exact sum")
        c.shutdown()
        del c, src, want
        gc.collect()
        torch.cuda.empty_cache()
        out[nbytes] = rec
    return out


def dp_checked_sum(torch, ref, checks: list):
    """A reduce op that folds with SUM and holds each of its ``chunk_reduce``
    launches bit for bit to the plain version on the same window (computed
    first: ``out`` may be ``a``)."""
    from repro_torch.core import api

    def checked(a, b, out=None):
        want = ref.chunk_reduce_ref(a, b, 1.0)
        got = api.SUM(a, b) if out is None else api.SUM.into(a, b, out)
        ok = torch.equal(got, want)
        checks.append((a.storage_offset() * a.element_size() % 16, a.numel(), ok))
        if not ok:
            raise AssertionError(f"chunk_reduce on a {a.dtype} window of {a.numel()}: not the plain version")
        return got

    return api.ReduceOp("sum, each window checked", checked, into=checked)


def dp_mixed(torch, ref, gen, card: str) -> dict:
    """The random f32 reduce against f64, and bf16 and f16 reduces whose
    every fold window is held to the plain version."""
    from repro_torch.core import api
    from repro_torch.core.local import LocalCluster

    out = {}
    n = DP_CHECK_BYTES // 4
    c = LocalCluster(DP_NODES, device="cuda")
    want = torch.zeros(n, dtype=torch.float64, device="cuda")
    for i in range(DP_NODES):
        x = torch.randn(n, generator=gen, device="cuda")
        want += x.double()
        c.put(i, f"f{i}", x)
    ids = [f"f{i}" for i in range(DP_NODES)]
    out["float32_random"] = dp_measure(torch, c, f"{DP_CHECK_BYTES} B random f32 reduce", DP_CHECK_BYTES,
                                       DP_NODES * DP_CHECK_BYTES,
                                       lambda: c.reduce(0, "r", ids, api.SUM, timeout=600), card)
    got = c.get(0, "r").double()
    err = float((got - want).abs().max())
    log(f"[dataplane] random f32 reduce against the f64 sum: max abs err {err:.3e} (rtol = atol = {DP_RANDOM_RTOL}), "
        f"on {card}")
    if not torch.allclose(got, want, rtol=DP_RANDOM_RTOL, atol=DP_RANDOM_RTOL):
        raise AssertionError(f"dataplane random f32 reduce: {err} from the f64 sum")
    out["float32_random"]["max_abs_err_vs_f64"] = err
    c.shutdown()
    for dtype in ("bfloat16", "float16"):
        dt = getattr(torch, dtype)
        n = DP_CHECK_BYTES // 2
        c = LocalCluster(DP_NODES, device="cuda")
        xs = [torch.randn(n, generator=gen, device="cuda").to(dt) for _ in range(DP_NODES)]
        for i, x in enumerate(xs):
            c.put(i, f"h{i}", x)
        ids = [f"h{i}" for i in range(DP_NODES)]
        checks = []
        op = dp_checked_sum(torch, ref, checks)
        rec = dp_measure(torch, c, f"{DP_CHECK_BYTES} B {dtype} reduce, each window checked", DP_CHECK_BYTES,
                         DP_NODES * DP_CHECK_BYTES, lambda: c.reduce(0, "r", ids, op, timeout=600), card)
        got = c.get(0, "r").double()
        exact = torch.stack([x.double() for x in xs]).sum(0)
        # each of the k - 1 folds rounds once: |error| <= (k - 1) u sum |x_i|
        slack = (DP_NODES - 1) * DP_UNIT_ROUNDOFF[dtype] * torch.stack([x.double().abs() for x in xs]).sum(0)
        within = bool(((got - exact).abs() <= slack).all())
        offsets = sorted({o for o, _, _ in checks})
        log(f"[dataplane] {dtype}: {len(checks)} fold windows, each bit for bit the plain version (window start "
            f"offsets from 16 bytes: {offsets}; {len({m for _, m, _ in checks})} window sizes); the result within "
            f"(k-1) u sum|x| of the exact sum: {within}, on {card}")
        if len(checks) != rec["sum_folds"] or not all(ok for _, _, ok in checks) or not within:
            raise AssertionError(f"dataplane {dtype}: {len(checks)} checked windows, {rec['sum_folds']} folds, "
                                 f"within the rounding bound {within}")
        rec["windows_checked"] = len(checks)
        out[dtype] = rec
        c.shutdown()
        del c, xs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_kill(torch, gen, card: str) -> dict:
    """A paced 1-D chain of DP_NODES - 2 sources at nodes 1.., a second copy
    of the tail's source at the last node; the tail is killed once the
    target's watermark passes half."""
    import threading

    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster

    k, nbytes = DP_NODES - 2, DP_KILL_BYTES
    c = LocalCluster(DP_NODES, device="cuda", pace=DP_KILL_PACE)
    want = torch.zeros(nbytes // 4, device="cuda")
    for i in range(k):
        x = dp_ints(torch, gen, nbytes)
        want += x
        c.put(i + 1, f"g{i}", x)
        if i == k - 1:
            c.put(DP_NODES - 1, f"g{i}", x)
        del x
    victim = k  # node k holds g_{k-1} and the chain's tail
    killed = {}

    def kill():
        deadline = time.time() + 300
        while time.time() < deadline and "at" not in killed:
            t = c.stores[0].get("r")
            if t is not None and t.bytes_present > nbytes // 2 and not t.complete:
                killed["at"] = t.bytes_present
                c.fail_node(victim)
            time.sleep(0.0005)

    killer = threading.Thread(target=kill, daemon=True)
    killer.start()
    rec = dp_measure(torch, c, f"{nbytes} B f32 reduce of {k}, paced {DP_KILL_PACE} s a window, the tail (node "
                     f"{victim}) killed past half", nbytes, k * nbytes,
                     lambda: c.reduce(0, "r", [f"g{i}" for i in range(k)], SUM, timeout=900), card)
    killer.join(timeout=60)
    exact = torch.equal(c.get(0, "r"), want)
    log(f"[dataplane] kill: node {victim} killed at the target's watermark {killed.get('at')} of {nbytes}; "
        f"resplices {rec['resplices']}; the result exact: {exact}; on {card}")
    if "at" not in killed or rec["resplices"] < 1 or not exact:
        raise AssertionError(f"dataplane kill: killed {killed}, resplices {rec['resplices']}, exact {exact}")
    rec["killed_at"] = killed["at"]
    c.shutdown()
    del c, want
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def dp_socket(torch, gen, card: str) -> dict:
    from repro_torch.core.api import SUM
    from repro_torch.core.local import LocalCluster

    n, nbytes = DP_SOCKET_NODES, DP_SOCKET_BYTES
    c = LocalCluster(n, device="cuda", comm_backend="socket")
    try:
        c.put(0, "b", dp_ints(torch, gen, nbytes))

        def bcast():
            for f in [c.prefetch_async(i, "b") for i in range(1, n)]:
                f.result(timeout=600)

        rec = {"broadcast": dp_measure(torch, c, f"socket backend: {nbytes} B f32 broadcast, node 0 to {n - 1}",
                                       nbytes, (n - 1) * nbytes, bcast, card)}
        src = c.get(0, "b")
        if not all(torch.equal(c.get(i, "b"), src) for i in range(1, n)):
            raise AssertionError("dataplane socket broadcast: a copy differs")
        want = torch.zeros(nbytes // 4, device="cuda")
        for i in range(n):
            x = dp_ints(torch, gen, nbytes)
            want += x
            c.put(i, f"g{i}", x)
        rec["reduce"] = dp_measure(torch, c, f"socket backend: {nbytes} B f32 reduce of {n}", nbytes, n * nbytes,
                                   lambda: c.reduce(0, "r", [f"g{i}" for i in range(n)], SUM, timeout=600), card)
        if not torch.equal(c.get(0, "r"), want):
            raise AssertionError("dataplane socket reduce: not the exact sum")
    finally:
        c.shutdown()
    return rec


def dataplane(torch, ref, card: str):
    """Hoplite's data plane on the card (see DP_SIZES).  Returns the phase's
    ``chunk_reduce`` launches and its records."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sizes = dp_paper_sizes(torch, gen, card)
    mixed = dp_mixed(torch, ref, gen, card)
    kill = dp_kill(torch, gen, card)
    sock = dp_socket(torch, gen, card)
    recs = [r for by_op in sizes.values() for r in by_op.values()] + list(mixed.values()) + [kill] + list(sock.values())
    launches = sum(r["chunk_reduce"] for r in recs)
    if not all(r["chunk_reduce"] > 0 for by_op in sizes.values() for op, r in by_op.items() if op != "broadcast"):
        raise AssertionError("dataplane: a reduce launched no chunk_reduce")
    phase_s = time.perf_counter() - t0
    log(f"[dataplane] phase {phase_s:.1f} s; chunk_reduce launches {launches}, each a SUM fold the cluster counted, "
        f"on {card}")
    return launches, {"sizes": {str(k): v for k, v in sizes.items()}, "checked": mixed, "kill": kill,
                      "socket": sock, "phase_s": phase_s}


# The parameter server (repro_torch/examples/async_parameter_server.py), the
# paper's flagship workload: first at the JAX example's defaults, then at
# ASGD_NODES nodes and ASGD_WORKERS workers (the first half of finishers
# reduced each round) with ResNet-50's parameter count in torchvision, so
# that every parameter and gradient object is 102.2 MB, ASGD_SAMPLES samples
# a shard drawn on the card, 12 rounds, the node holding the newest
# parameters killed after round 6.
ASGD_NODES, ASGD_WORKERS = 8, 8
ASGD_DIM = 25_557_032
ASGD_SAMPLES = 16


def asgd(torch, card: str):
    from repro_torch.examples import async_parameter_server as ps
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    small = ps.run(device="cuda", log=lambda m: log(f"[asgd] defaults: {m}, on {card}"))
    small_launches = ops.launch_counts()["chunk_reduce"]
    ls = small["losses"]
    log(f"[asgd] defaults (dim {ps.DIM}, {ps.NUM_NODES} nodes, {ps.NUM_WORKERS} workers): loss {ls[0]:.4f} -> "
        f"{ls[-1]:.4f}, tasks {small['tasks_executed']}, re-executed {small['tasks_reexecuted']}, chunk_reduce "
        f"launches {small_launches}, on {card}")
    if not ls[-1] < 0.7 * ls[0]:
        raise AssertionError(f"asgd at the defaults: loss {ls[0]} -> {ls[-1]}")
    small["runtime"].cluster.shutdown()
    del small
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    big = ps.run(ASGD_NODES, ASGD_WORKERS, ASGD_DIM, ASGD_SAMPLES, device="cuda", data="device",
                 log=lambda m: log(f"[asgd] dim {ASGD_DIM}: {m}, on {card}"))
    launches = ops.launch_counts()["chunk_reduce"]
    folds = big["runtime"].cluster.stats["fold_ops"]
    peak = torch.cuda.max_memory_allocated()
    lb = big["losses"]
    rec = {"dim": ASGD_DIM, "object_bytes": ASGD_DIM * 4, "nodes": ASGD_NODES, "workers": ASGD_WORKERS,
           "samples": ASGD_SAMPLES, "lr": big["lr"], "losses": lb, "round_s": big["round_s"],
           "tasks_executed": big["tasks_executed"], "tasks_reexecuted": big["tasks_reexecuted"],
           "chunk_reduce": launches, "sum_folds": folds, "peak_bytes": peak,
           "defaults": {"losses": ls, "chunk_reduce": small_launches}}
    log(f"[asgd] {ASGD_NODES} nodes, {ASGD_WORKERS} workers, dim {ASGD_DIM} ({ASGD_DIM * 4 / 1e6:.1f} MB objects), "
        f"{ASGD_SAMPLES} samples a shard: loss {lb[0]:.4f} -> {lb[-1]:.4f} ({lb[-1] / lb[0]:.4f}x), rounds "
        f"{statistics.median(big['round_s']) * 1e3:.1f} ms median ({min(big['round_s']) * 1e3:.1f}-"
        f"{max(big['round_s']) * 1e3:.1f}), tasks {big['tasks_executed']}, re-executed {big['tasks_reexecuted']}, "
        f"chunk_reduce launches {launches} (SUM folds {folds}), max_memory_allocated {peak / 1e9:.2f} GB, on {card}")
    big["runtime"].cluster.shutdown()
    del big
    gc.collect()
    torch.cuda.empty_cache()
    if not lb[-1] < 0.7 * lb[0] or rec["tasks_reexecuted"] < 1 or launches != folds or launches == 0:
        raise AssertionError(f"asgd: loss {lb[0]} -> {lb[-1]}, re-executed {rec['tasks_reexecuted']}, "
                             f"launches {launches} against {folds} folds")
    rec["phase_s"] = time.perf_counter() - t_phase
    return small_launches + launches, rec


# Hoplite-Serve (repro_torch/serve/) on the card, at the sizes of the JAX
# package's own ensemble scenario: simulation.ensemble_serving's defaults (8
# replicas, 64 MB weights, 256 KB inputs and replies) and EnsembleConfig's
# (a quorum of 5 of 8), on Runtime(num_nodes=8, executors_per_node=4).  The
# weights are a (4096, 4096) f32 matrix W drawn from SEED, the payloads
# (16, 4096) f32, a replica's reply x @ W.  40 requests arrive open loop at
# 40 rps (the rate of the JAX benchmark's threaded run); the node of replica
# 7 is killed at request 10, a second seeded W is published at request 20
# and one replica is added (its weights staged through the broadcast tree)
# at request 30, each before that request is offered.  SE_WARMUP requests
# first run one at a time, with no other in flight: a request's service
# time alone, beside the open loop's latency.
SE_NODES, SE_EXECUTORS, SE_REPLICAS, SE_QUORUM = 8, 4, 8, 5
SE_D, SE_ROWS = 4096, 16
SE_REQUESTS, SE_RATE, SE_WARMUP = 40, 40.0, 3
SE_KILL_AT, SE_SWAP_AT, SE_ADD_AT, SE_KILLED_REPLICA = 10, 20, 30, 7
SE_UNIT_ROUNDOFF = 2.0 ** -24  # f32


def se_version_of(torch, value, refs, k: int):
    """The version whose reference the value lies within, or None.  A
    reference is the f64 mean of k replies of one product (the replies are
    the same f32 product y, so it is y in f64); the k - 1 folds round once
    each and the division once: |got - mean| <= (k-1) u sum|y_i| / k + u |mean|,
    which is k u |y| for k equal replies."""
    got = value.double()
    hits = []
    for v, y in refs.items():
        mean = y.double()
        if bool(((got - mean).abs() <= k * SE_UNIT_ROUNDOFF * mean.abs()).all()):
            hits.append(v)
    return hits[0] if len(hits) == 1 else None


def se_request_state(rt, weight_ids) -> tuple:
    """What the requests hold: objects in the stores, refs and lineage
    entries, the weight objects left out."""
    return (sum(1 for s in rt.cluster.stores for oid in s.objects if oid not in weight_ids),
            sum(1 for rid in rt._refs if rid not in weight_ids),
            sum(1 for rid in rt._lineage if rid not in weight_ids))


def se_stream(torch, card: str, device: str = "cuda", d: int = SE_D, rows: int = SE_ROWS,
              rate: float = SE_RATE) -> dict:
    """Drive the ensemble through the router as set out above and check it.
    On the CPU (``device="cpu"``, tests at small ``d``) no kernel launches
    and the SUM folds go through ``chunk_reduce``'s plain version."""
    from repro_torch.core.api import SUM
    from repro_torch.kernels import ops
    from repro_torch.runtime import Runtime
    from repro_torch.serve import EnsembleConfig, EnsembleGroup, OpenLoopRouter, RouterConfig, ServeMetrics

    cuda = device == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    weights = [torch.randn(d, d, generator=gen, device=device) / math.sqrt(d) for _ in range(2)]
    payloads = [torch.randn(rows, d, generator=gen, device=device) for _ in range(SE_REQUESTS)]
    refs = [{v: torch.matmul(x, w) for v, w in enumerate(weights, 1)} for x in payloads]

    def model(w, x):
        return torch.matmul(x, w)

    rt = Runtime(num_nodes=SE_NODES, executors_per_node=SE_EXECUTORS, device=device)
    ens = EnsembleGroup(rt, model, EnsembleConfig(num_replicas=SE_REPLICAS, quorum=SE_QUORUM))
    k = ens.config.quorum
    deploy_s = []

    def deploy(w):
        t0 = time.perf_counter()
        version = ens.deploy(w)
        if cuda:
            torch.cuda.synchronize()
        deploy_s.append(time.perf_counter() - t0)
        return version

    deploy(weights[0])
    weight_ids = {r.id for r in ens.deployment.held_refs()}
    before = se_request_state(rt, weight_ids)
    alone_s = []
    for x in payloads[:SE_WARMUP]:
        t0 = time.perf_counter()
        ens.handle_request(x)
        if cuda:
            torch.cuda.synchronize()
        alone_s.append(time.perf_counter() - t0)
    ens.metrics = metrics = ServeMetrics()  # the stream's own counts
    added = {}

    def on_arrival(idx: int) -> None:
        # each before request idx is offered, with the earlier requests in flight
        if idx == SE_KILL_AT:
            ens.kill_replica(SE_KILLED_REPLICA)
        elif idx == SE_SWAP_AT:
            deploy(weights[1])
        elif idx == SE_ADD_AT:
            handle = ens.add_replica()
            _, wref = ens.deployment.current()
            added.update(node=handle.node, replica=handle.replica_id,
                         staged=rt.cluster.stores[handle.node].contains(wref.id))

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    SUM.reset_counts()
    ops.reset_launch_counts()
    folds0 = rt.cluster.stats["fold_ops"]
    metrics.capture_bytes(rt.cluster.bytes_sent_per_node)
    router = OpenLoopRouter(ens, RouterConfig(rate_rps=rate, max_outstanding=64), metrics)
    t0 = time.perf_counter()
    router.run_open_loop(payloads, on_arrival=on_arrival, drain_timeout=120.0)
    if cuda:
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = ops.launch_counts()["chunk_reduce"]
    folds = rt.cluster.stats["fold_ops"] - folds0 + ens.lineage_folds
    snap = metrics.snapshot()

    # every value within the rounding bound of the version it captured (the
    # pointer flipped before request SE_SWAP_AT was offered), never a mix
    versions = {}
    for idx, value in router.results:
        v = se_version_of(torch, value, refs[idx], k)
        if v != (1 if idx < SE_SWAP_AT else 2):
            raise AssertionError(f"serve_ensemble request {idx}: version {v} (None: within the bound of no one "
                                 f"version's reference, a mix or wrong)")
        versions[v] = versions.get(v, 0) + 1

    # nothing the requests made is left once the stragglers have finished
    weight_ids = {r.id for r in ens.deployment.held_refs()}
    deadline = time.time() + 60.0
    while se_request_state(rt, weight_ids) != before and time.time() < deadline:
        time.sleep(0.01)
    after = se_request_state(rt, weight_ids)

    lat = snap["latency"]
    rec = {"offered": snap["offered"], "completed": snap["completed"], "rejected": snap["rejected"],
           "failed": snap["failed"], "versions_served": {str(v): n for v, n in sorted(versions.items())},
           "latency_s": {q: lat[q] for q in ("p50", "p99", "max", "mean")}, "alone_s": alone_s, "deploy_s": deploy_s,
           "stream_s": stream_s, "throughput_rps": snap["completed"] / stream_s, "sum_folds": folds,
           "lineage_folds": ens.lineage_folds, "chunk_reduce": launches, "sum_counts": dict(SUM.counts),
           "peak_bytes": peak, "bytes_moved": sum(metrics.bytes_moved(rt.cluster.bytes_sent_per_node)),
           "per_replica": {str(r): n for r, n in sorted(snap["per_replica"].items())}, "added": added,
           "alive_replicas": len(ens.alive_replicas()), "tasks_reexecuted": rt.tasks_reexecuted,
           "request_state_before": before, "request_state_after": after}
    log(f"[serve_ensemble] {snap['offered']} requests at {rate} rps, {SE_REPLICAS} replicas, quorum {k}, "
        f"{d}x{d} f32 weights ({d * d * 4 / 1e6:.1f} MB), ({rows}, {d}) payloads: completed {snap['completed']}, "
        f"rejected {snap['rejected']}, failed {snap['failed']}; versions served {rec['versions_served']}; "
        f"latency p50 {lat['p50'] * 1e3:.2f} ms, p99 {lat['p99'] * 1e3:.2f} ms, max {lat['max'] * 1e3:.2f} ms "
        f"(a request alone, closed loop: {', '.join(f'{a * 1e3:.2f}' for a in alone_s)} ms); "
        f"throughput {rec['throughput_rps']:.2f} rps over {stream_s:.3f} s; deploy "
        f"{', '.join(f'{s * 1e3:.2f}' for s in deploy_s)} ms (versions 1, 2); chunk_reduce launches {launches} "
        f"against SUM folds {folds} (lineage {ens.lineage_folds}); max_memory_allocated {peak / 1e9:.3f} GB; "
        f"replica added {added}; on {card}")
    rt.cluster.shutdown()

    problems = []
    if snap["completed"] + snap["rejected"] + snap["failed"] != snap["offered"] or snap["failed"] or router.errors:
        problems.append(f"offered {snap['offered']} != completed + rejected + failed, or failures {router.errors}")
    if not added.get("staged") or snap["per_replica"].get(added["replica"], 0) < 1:
        problems.append(f"the added replica: {added}, completed {snap['per_replica']}")
    if versions.get(2, 0) < 1 or len(deploy_s) != 2:
        problems.append(f"the hot swap served no request: {versions}, deploys {deploy_s}")
    if ens.replicas[SE_KILLED_REPLICA].alive:
        problems.append("the killed replica is still alive")
    if after != before:
        problems.append(f"requests leaked: {before} before the stream, {after} after")
    want_launches = folds if cuda else 0
    if launches != want_launches or SUM.counts != {"chunk_reduce": folds} or folds < (k - 1) * snap["completed"]:
        problems.append(f"{folds} SUM folds, {launches} chunk_reduce launches, SUM {SUM.counts}, "
                        f"{snap['completed']} completed")
    if problems:
        raise AssertionError("serve_ensemble: " + "; ".join(problems))
    return rec


def serve_ensemble(torch, card: str):
    t0 = time.perf_counter()
    rec = se_stream(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t0
    log(f"[serve_ensemble] phase {rec['phase_s']:.1f} s, on {card}")
    return rec["chunk_reduce"], rec


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker if it runs.  The sync phase's
    spawned ranks start it, and a Python whose tracker has no finalizer lets it
    outlive this script until it reads the end of its pipe."""
    from multiprocessing import resource_tracker

    gc.collect()  # the rank queues' semaphores unregister as they are freed
    resource_tracker._resource_tracker._stop()


def check_no_children() -> None:
    """Fail if any process this script started is still there (running or
    not yet reaped): every phase stops what it starts."""
    me, left = str(os.getpid()), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # ended while we looked
            continue
        name, rest = text[text.index("(") + 1:].rsplit(")", 1)
        state, ppid = rest.split()[:2]
        if ppid == me:
            left.append(f"{stat.parent.name} {name} (state {state})")
    if left:
        raise AssertionError(f"child processes left: {left}")
    log("[card] no child process left")


PHASES = ("dataplane", "asgd", "serve_ensemble", "serve", "serve_f32", "serve_moe", "serve_dense", "serve_ssm",
          "serve_encdec", "sync", "train", "dryrun", "ckpt", "pods", "mesh")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU (every phase by default).")
    p.add_argument("--only", default=",".join(PHASES),
                   help="comma-separated phases to drive after the build and the kernel checks "
                        f"(default: all of {', '.join(PHASES)}; dryrun needs train)")
    args = p.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(PHASES) or ("dryrun" in only and "train" not in only):
        p.error(f"--only takes phases of {PHASES}, dryrun with train")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port is missing ({src / 'repro_torch'})", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_reduce as cr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.optim import compression

    # Phase 1: the card, and the kernels built from source.
    start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi:")
    log(card)
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(built) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    reports = {name: _build.report(name) for name in _build.SOURCES}
    for name, rep in sorted(reports.items()):
        if name == "rmsnorm":  # dozens of instances: their range and the most any spills
            regs = [int(n) for n in re.findall(r"Used (\d+) registers", rep)]
            log(f"[build] rmsnorm: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, at most "
                f"{spill_bytes(rep)} spill bytes")
            continue
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    if spill_bytes(reports["rmsnorm"]):
        raise AssertionError(f"an rmsnorm kernel spills {spill_bytes(reports['rmsnorm'])} bytes")
    spills, instances = {}, {}
    for route, lib, kernel in (("tc", "flash_attention_sm90", "flash_fwd_sm90_kernel"),
                               ("f32", "flash_attention", "flash_fwd_f32_kernel")):
        spills[route] = spill_bytes(reports[lib])
        instances[route] = flash_instances(reports[lib], kernel)
        log(f"[build] {lib} (the {route} route): {spills[route]} spill bytes; by head dim "
            f"{json.dumps(instances[route])}")
        if spills[route] or len(instances[route]) != len(fa.TC_HEAD_DIMS):
            raise AssertionError(f"the {route} flash kernel spills {spills[route]} bytes, or has instances for "
                                 f"{sorted(instances[route])} only")

    # Phase 2: each kernel against its plain version, on the card.
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = get_config(ARCH)
    records = [check_rmsnorm(torch, rn, ref, gen), *check_flash(torch, fa, ref, gen, spills, instances),
               check_chunk_reduce(torch, cr, ref, gen, *hop_chunks(cfg, C)),
               check_dequant_add(torch, cr, ref, compression, gen, cfg.d_model * cfg.d_ff)]
    next(r for r in records if r["name"] == "chunk_reduce").update(check_chunk_reduce_f16(torch, cr, ref, gen))
    check_flash_backward(torch, ops, gen)
    t0 = time.perf_counter()
    prefill_shapes = {f"{arch} {attention}": check_flash_at(torch, fa, ref, gen, arch, attention)
                      for arch, attention in FLASH_PREFILL}
    log(f"[kernels] the flash at the serve_moe, serve_dense, serve_ssm and serve_encdec prefill shapes: "
        f"{time.perf_counter() - t0:.1f} s")
    records[1].update({f"window_{key}": val for key, val in prefill_shapes.pop("mixtral-8x22b window").items()
                       if key != "kernel_route"})
    records[1]["serve_ssm_shapes"] = {key: prefill_shapes.pop(key) for key in list(prefill_shapes)
                                      if key.split()[0] in SSM_RUNS}
    records[1]["serve_encdec_shapes"] = {key: prefill_shapes.pop(key) for key in list(prefill_shapes)
                                         if key.split()[0] in ENCDEC_RUNS}
    records[1]["serve_dense_shapes"] = prefill_shapes
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {}  # launches of each kernel on each main path

    # Phase 2b: Hoplite's data plane on the card: every SUM fold window is chunk_reduce.
    if "dataplane" in only:
        dp_launches, dp_metrics = dataplane(torch, ref, card)
        by_path["dataplane"] = {"chunk_reduce": dp_launches}
        log(f"[dataplane] metrics {json.dumps(dp_metrics)} on {card}")

    # Phase 2c: the asynchronous parameter server over the task runtime.
    if "asgd" in only:
        asgd_launches, asgd_metrics = asgd(torch, card)
        by_path["asgd"] = {"chunk_reduce": asgd_launches}
        log(f"[asgd] metrics {json.dumps(asgd_metrics)} on {card}")

    # Phase 2d: Hoplite-Serve's ensemble over the runtime: every SUM fold of the k replies is chunk_reduce.
    if "serve_ensemble" in only:
        se_launches, se_metrics = serve_ensemble(torch, card)
        by_path["serve_ensemble"] = {"chunk_reduce": se_launches}
        log(f"[serve_ensemble] metrics {json.dumps(se_metrics)} on {card}")

    # Phase 3: serve the full-width model through the port's entry points.
    if "serve" in only:
        by_path["serve"], metrics = serve(torch, card)
        log(f"[serve] metrics {json.dumps(metrics)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()  # the engine's 30 GB go back before the next phase

    # Phase 3a: serve the full-width model in f32 through the f32 flash kernel.
    if "serve_f32" in only:
        by_path["serve_f32"], f32_metrics = serve_f32(torch, card)
        log(f"[serve_f32] metrics {json.dumps(f32_metrics)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()

    # Phase 3b: serve the MoE family at full width, depth cut.
    if "serve_moe" in only:
        t0 = time.perf_counter()
        dispatch = check_moe_dispatch(torch)
        log(f"[serve_moe] the dispatch check: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        by_path["serve_moe"], moe_metrics = serve_moe(torch, card)
        log(f"[serve_moe] metrics {json.dumps(dict(moe_metrics, dispatch=dispatch))} on {card}")

    # Phase 3c: serve the rest of the dense-attention family at full width.
    if "serve_dense" in only:
        by_path["serve_dense"], dense_metrics = serve_dense(torch, card)
        log(f"[serve_dense] metrics {json.dumps(dense_metrics)} on {card}")

    # Phase 3d: serve the SSM families at full width.
    if "serve_ssm" in only:
        by_path["serve_ssm"], ssm_metrics = serve_ssm(torch, card)
        log(f"[serve_ssm] metrics {json.dumps(ssm_metrics)} on {card}")

    # Phase 3e: serve the encoder-decoder at full width and depth.
    if "serve_encdec" in only:
        by_path["serve_encdec"], encdec_metrics = serve_encdec(torch, card)
        log(f"[serve_encdec] metrics {json.dumps(encdec_metrics)} on {card}")

    # Phase 4: the cross-pod gradient sync on rank processes sharing the card.
    if "sync" in only:
        summary = sync(torch, card)
        by_path["sync"] = {"chunk_reduce": sum(summary["methods"]["hoplite_chain"]["chunk_reduce"])}
        log(f"[sync] metrics {json.dumps(summary)} on {card}")

    # Phase 5: the train step at full width, depth cut.
    if "train" in only:
        by_path["train"], train_metrics = train(torch, card)
        log(f"[train] metrics {json.dumps(train_metrics)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()

    # Phase 5a: the dry run's trace of the train step, against the train phase's peak.
    if "dryrun" in only:
        dry_metrics = dryrun(torch, card, train_metrics)
        log(f"[dryrun] metrics {json.dumps(dry_metrics)} on {card}")

    # Phase 5b: checkpoint and restart of the train state.
    if "ckpt" in only:
        by_path["ckpt"], ckpt_metrics = ckpt(torch, card)
        log(f"[ckpt] metrics {json.dumps(ckpt_metrics)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()

    # Phase 5c: the launcher's multi-pod training, each pod a rank process.
    if "pods" in only:
        by_path["pods"], pod_metrics = pods(torch, card)
        log(f"[pods] metrics {json.dumps(pod_metrics)} on {card}")
        gc.collect()
        torch.cuda.empty_cache()

    # Phase 5d: the launchers over the debug mesh, 8 rank processes on the card.
    if "mesh" in only:
        by_path["mesh"], mesh_metrics = mesh(torch, card)
        log(f"[mesh] metrics {json.dumps(mesh_metrics)} on {card}")

    stop_resource_tracker()
    check_no_children()
    for r in records:
        name = "flash_attention_tc" if r["name"] == "flash_attention" else r["name"]
        r["launches_by_path"] = {path: c.get(name, 0) for path, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())

    # Phase 6 and 7: the kernels record, then the result.
    log(f"[card] all phases: {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:  # also when a phase raised
        stop_resource_tracker()
    sys.exit(code)
