#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds each against its plain PyTorch version at the main paths'
shapes and the sweeps of tests/test_kernels.py, then drives two paths:

- serve: qwen3-14b at full width (40 layers, d=5120, bf16 weights drawn on
  the card from seed 0), 4 prompts of 512 tokens, 32 greedy tokens each, with
  a max_seq of 1024.  It checks that the serve run launched the kernels, that
  the tokens and logits are sane, and that decode agrees with prefill, then
  times prefill and decode and profiles one of each (kernel busy time).
- sync: the train step's cross-pod gradient sync (``launch/sync.py``) on 4
  rank processes that share the card, over the bf16 gradient tree of one
  full-width qwen3-14b decoder block per rank, by every method.  Each rank
  checks its hop-kernel launches against the schedules' prediction and its
  result against the seeded mean; the chain methods' ranks must agree bit
  for bit.  Ranks 0 and 1 also measure the host-staged link, and all ranks
  measure it once more under load, exchanging around the ring at once.

Every phase raises on failure; the script then exits non-zero.

The last two lines are a JSON ``kernels`` record (times, bounds, launches)
and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Cycles the card spins before each timed run (about 0.1 ms), longer than the
# host takes to enqueue any one kernel here.
SPIN_CYCLES = 200_000

# tests/test_kernels.py:16-17, used as both rtol and atol
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

FLASH_CASES = [
    # (B, H, Kh, Sq, Skv, D, causal, window): tests/test_kernels.py:24-32
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 4, 1, 256, 256, 32, True, 0),
    (1, 2, 2, 128, 128, 64, False, 0),
    (1, 2, 2, 256, 256, 64, True, 64),
    (1, 2, 1, 64, 512, 64, True, 0),
]

ARCH, BATCH, PROMPT, NEW_TOKENS, MAX_SEQ, SEED = "qwen3-14b", 4, 512, 32, 1024, 0

# The sync phase: rank processes on the one card (each with one decoder
# block of gradients)
SYNC_RANKS = 4

# Names of the port's kernels in a profile (see device_profile).
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_kernel", "rmsnorm", "chunk_reduce_kernel")

# Decode versus prefill of the longer prompt, in bf16 (see check_cache).
CACHE_REL_L2_TOL = 5e-2


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
    run follows a write of 64 MB that evicts the 50 MB L2 and a spin of the
    card (``torch.cuda._sleep``) that keeps it busy while the host enqueues
    ``fn``, so the host's launch overhead (Python, ctypes, the tensor maps)
    is not counted: the events bracket the device's work."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        flush.zero_()
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


def check_rmsnorm(torch, rn, ref, gen):
    """Kernel against plain version; returns the record at the path's shape."""
    rows = BATCH * PROMPT
    shapes = [(rows, 5120), (rows * 40, 128), (BATCH, 5120), (5, 16383)]
    path_err = None
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            w = (torch.randn(shape[-1], generator=gen, device="cuda") * 0.1).to(dt)
            err = compare(torch, f"rmsnorm {shape} {dtype}", rn.rmsnorm(x, w), ref.rmsnorm_ref(x, w), dtype)
            if shape == shapes[0] and dtype == "bfloat16":
                path_err = err
    torch.cuda.synchronize()
    x = torch.randn(shapes[0], generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(5120, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    w1 = 1.0 + w  # the library call takes the whole scale
    ms = time_ms(torch, lambda: rn.rmsnorm(x, w))
    plain = time_ms(torch, lambda: ref.rmsnorm_ref(x, w))
    lib = time_ms(torch, lambda: torch.nn.functional.rms_norm(x, (5120,), w1, 1e-6))
    b_ms, b_by = bound(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), "bfloat16")
    log(f"[kernels] rmsnorm {tuple(x.shape)} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"F.rms_norm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:25", "shape": f"x {tuple(x.shape)} bf16",
        "max_abs_err": path_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
    }


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


def flash_inputs(torch, gen, B, H, Kh, Sq, Skv, D, dt):
    """q of std 2 and k, v of std 1: the scaled scores q.k / sqrt(D) have a
    std of 2 (the qk-normed serve path's are near 1), so the softmax is far
    from uniform and the output depends on every score."""
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda") * 2
    k = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda")
    v = torch.randn(B, Kh, Skv, D, generator=gen, device="cuda")
    return q.to(dt), k.to(dt), v.to(dt)


def check_sensitive(torch, ref, what, got, q, k, v, causal, window, q_offset):
    """The 2e-2 check must fail an output that a wrong Q.K^T would give: the
    plain version with K's columns rolled by 8 (one 16-byte unit, as a wrong
    swizzle or descriptor would read them) and with S = 0 (K zeroed)."""
    for wrong, kk in (("K's columns rolled by 8", k.roll(8, dims=-1)), ("S = 0", torch.zeros_like(k))):
        bad = ref.flash_attention_ref(q, kk, v, causal, window, q_offset)
        if torch.allclose(got.float(), bad.float(), rtol=TOL["bfloat16"], atol=TOL["bfloat16"]):
            raise AssertionError(f"{what}: the bf16 check cannot tell the output from {wrong}")


def check_flash(torch, fa, ref, gen, spills: int):
    """Both routes against the plain version: bf16 with D 64 or 128 on the
    tensor cores, f32 and bf16 of the other head dims on the CUDA cores.  On
    the tensor-core cases whose rows see a key, the check is also shown to
    fail a wrong Q.K^T.  Times the tensor-core route at the serve shape and
    the CUDA-core route on the same inputs in f32."""
    cfg_case = (BATCH, 40, 8, PROMPT, PROMPT, 128, True, 0)
    ragged = (BATCH, 40, 8, PROMPT + 1, PROMPT + 1, 128, True, 0)  # prefill of prompt + token
    window = (1, 2, 1, 200, 200, 64, True, 16)  # with q_offset -20: the first rows see no key
    path_err = None

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for case in [cfg_case, ragged, window] + FLASH_CASES:
            B, H, Kh, Sq, Skv, D, causal, win = case
            q, k, v = flash_inputs(torch, gen, B, H, Kh, Sq, Skv, D, dt)
            off = -20 if case == window else Skv - Sq
            before = fa.launches_tc
            got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win, q_offset=off)
            route = fa.route(dt, D)
            if (fa.launches_tc > before) != (route == "tc"):
                raise AssertionError(f"flash {case} {dtype}: launched off its route {route}")
            what = f"flash {case} q_offset={off} {dtype} ({route})"
            err = compare(torch, what, got, ref.flash_attention_ref(q, k, v, causal, win, off), dtype)
            if route == "tc":
                check_sensitive(torch, ref, what, got, q, k, v, causal, win, off)
            if case == cfg_case and dtype == "bfloat16":
                path_err = err
    log("[kernels] flash: on every tensor-core case the bf16 check fails K with rolled columns and S = 0")
    torch.cuda.synchronize()
    B, H, Kh, S, _, D, _, _ = cfg_case
    q, k, v = flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.bfloat16)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, True, 0, 0))
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = time_ms(torch, lambda: fa.flash_attention_fwd(qf, kf, vf, causal=True))
    ops = 4 * B * H * D * flash_pairs(torch, S, S, True, 0, 0)  # QK^T and PV, 2 ops per MAC
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2, ops, "bfloat16")  # q, o, k, v
    f32_bound, f32_by = bound((2 * q.numel() + k.numel() + v.numel()) * 4, ops, "float32")
    log(f"[kernels] flash {tuple(q.shape)}x{tuple(k.shape)} causal bf16 (tensor cores, {spills} spill "
        f"bytes): kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms ({ms / lib:.3f}x), "
        f"bound {b_ms:.4f} ms ({b_by}), {ops / ms / 1e9:.2f} TFLOP/s")
    log(f"[kernels] flash same shape f32 (CUDA cores): kernel {f32_ms:.4f} ms, bound {f32_bound:.4f} ms "
        f"({f32_by}), {ops / f32_ms / 1e9:.2f} TFLOP/s")
    return {
        "name": "flash_attention", "route": "cuda", "kernel_route": "tc",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:93",
        "shape": f"q {tuple(q.shape)} kv {tuple(k.shape)} causal bf16",
        "max_abs_err": path_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "spill_bytes": spills,
        "f32_route": "cores", "f32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "f32_ms": f32_ms, "f32_bound_ms": f32_bound,
    }


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
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for alpha in (1.0, 0.5):
                for into in ("new", "dst"):
                    dst = torch.randn(n, generator=gen, device="cuda").to(dt)
                    src = torch.randn(n, generator=gen, device="cuda").to(dt)
                    want = ref.chunk_reduce_ref(dst, src, alpha)
                    got = cr.chunk_reduce(dst, src, alpha, out=dst if into == "dst" else None)
                    compare(torch, f"chunk_reduce n={n} {dtype} alpha={alpha} out={into}", got, want, dtype)
                    same(f"n={n} {dtype}", got, want)
    for dtype in ("float32", "bfloat16"):
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
    log("[kernels] chunk_reduce: bit for bit at every row of (8, 10007) and every src offset, bf16 and f32")

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


def expected_launches(cfg, decode_steps: int):
    """RMSNorm: ln1 + ln2 + final, the qk-norm of q and k, and in prefill
    the k-norm again (attention_prefill_kv recomputes k, as the JAX package
    does).  Flash attention: once per layer in prefill, all on the tensor
    cores (bf16, head dim 128); decode has none."""
    L = cfg.num_layers
    per_decode = 2 * L + 1 + 2 * L
    prefill = per_decode + L
    return {"rmsnorm": prefill + decode_steps * per_decode, "flash_attention_tc": L,
            "flash_attention_cores": 0, "chunk_reduce": 0, "dequant_add": 0}


def check_cache(torch, T, eng, toks):
    """Decode step 1 against the last position of prefill(prompt + token).

    Both sides run bf16 weights and activations: the two paths round in
    different places (the flash kernel against decode's plain attention,
    matmuls of 2052 rows against 4), and 40 layers carry those roundings on.
    Held as a relative L2 error of the logit vector against CACHE_REL_L2_TOL,
    and the greedy token must agree on most rows."""
    cfg, params = eng.cfg, eng.params
    with torch.inference_mode():
        logits, caches = T.prefill(cfg, params, {"tokens": toks}, MAX_SEQ)
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        first = logits[:, : cfg.vocab_size].argmax(-1)[:, None]  # greedy, as the engine
        step1, _ = T.decode_step(cfg, params, first, PROMPT, caches)
        longer, _ = T.prefill(cfg, params, {"tokens": torch.cat([toks, first], dim=1)}, MAX_SEQ)
    if not torch.isfinite(step1).all():
        raise AssertionError("decode logits are not finite")
    V = cfg.vocab_size
    a, b = step1[:, :V].float(), longer[:, :V].float()
    rel = ((a - b).norm() / b.norm()).item()
    max_abs = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[serve] cache check: decode step 1 vs prefill(prompt + token): rel_l2={rel:.3e} "
        f"max_abs={max_abs:.3e} (|logit| max {b.abs().max().item():.3f}) argmax agree {agree:.2f}")
    if rel > CACHE_REL_L2_TOL:
        raise AssertionError(f"decode disagrees with prefill: rel_l2 {rel} > {CACHE_REL_L2_TOL}")
    return rel, max_abs


def serve(torch, card: str):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeOptions
    from repro_torch.tree import leaves

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    eng = build_engine(cfg, "cuda", SEED, ServeOptions(max_seq=MAX_SEQ, batch_size=BATCH))
    torch.cuda.synchronize()
    weight_gb = sum(t.numel() * t.element_size() for t in leaves(eng.params)) / 1e9
    log(f"[serve] {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, {weight_gb:.2f} GB of "
        f"{cfg.param_dtype} weights drawn on the card in {time.perf_counter() - t0:.1f} s")
    tokens = random_prompts(cfg, BATCH, PROMPT, SEED)
    toks = torch.as_tensor(tokens, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate({"tokens": tokens}, NEW_TOKENS)  # the main path
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected_launches(cfg, NEW_TOKENS - 1)
    log(f"[serve] generate: {out.shape} tokens in {gen_s:.3f} s; launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"tokens out of range or of the wrong shape: {out.shape}, {out.min()}..{out.max()}")

    rel, max_abs = check_cache(torch, T, eng, toks)

    with torch.inference_mode():
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = T.prefill(cfg, eng.params, {"tokens": toks}, MAX_SEQ)
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
        tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(NEW_TOKENS - 1):
            logits, caches = T.decode_step(cfg, eng.params, tok, PROMPT + i, caches)
            tok = logits[:, : cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / (NEW_TOKENS - 1)
        prefill_ms = statistics.median(pre)
        prefill_busy = device_profile(
            torch, lambda: T.prefill(cfg, eng.params, {"tokens": toks}, MAX_SEQ), "prefill", prefill_ms)
        decode_busy = device_profile(
            torch, lambda: T.decode_step(cfg, eng.params, tok, PROMPT + NEW_TOKENS - 1, caches),
            "decode step", dec_ms)
    log(f"[serve] {card}: prefill {BATCH}x{PROMPT} {prefill_ms:.2f} ms (median of 3), decode "
        f"{dec_ms:.2f} ms per step of {BATCH} tokens, generate {BATCH * NEW_TOKENS / gen_s:.1f} tok/s "
        f"(prefill included), peak memory {peak_gb:.2f} GB")
    return counts, {"prefill_ms": prefill_ms, "decode_ms_per_step": dec_ms,
                    "prefill_kernel_busy_ms": prefill_busy, "decode_kernel_busy_ms": decode_busy,
                    "generate_tok_s": BATCH * NEW_TOKENS / gen_s, "peak_gb": peak_gb,
                    "cache_rel_l2": rel, "cache_max_abs": max_abs}


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


def device_profile(torch, fn, label: str, wall_ms: float):
    """Device busy time of one call of ``fn`` by torch.profiler: the union of
    the intervals of its device-side events (kernels, copies), against the
    unprofiled wall time, and the device events that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    per_name = {}
    for e in events:
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]
    busy = busy_us / 1e3
    log(f"[profile] {label}: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%), {len(events)} device events; top: " + "; ".join(
            f"{name[:60]} {t / 1e3:.2f} ms x{n}" for name, (t, n) in top))
    ours = {k: sum(t for name, (t, _) in per_name.items() if k in name) for k in PORT_KERNELS}
    counts = {k: sum(n for name, (_, n) in per_name.items() if k in name) for k in PORT_KERNELS}
    log(f"[profile] {label}: the port's kernels: " + "; ".join(
        f"{k} {ours[k] / 1e3:.3f} ms x{counts[k]}" for k in PORT_KERNELS))
    return busy


def main() -> int:
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
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.optim import compression

    # Phase 1: the card, and the kernels built from source.
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi:")
    log(card)
    t0 = time.perf_counter()
    built = _build.build()
    log(f"[build] {sorted(built) or 'cached'} in {time.perf_counter() - t0:.1f} s")
    reports = {name: _build.report(name) for name in _build.SOURCES}
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    spills = spill_bytes(reports["flash_attention_sm90"])
    log(f"[build] flash_attention_sm90 (the tensor-core route): {spills} spill bytes")
    if spills:
        raise AssertionError(f"the tensor-core flash kernel spills {spills} bytes")

    # Phase 2: each kernel against its plain version, on the card.
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = get_config(ARCH)
    records = [check_rmsnorm(torch, rn, ref, gen), check_flash(torch, fa, ref, gen, spills),
               check_chunk_reduce(torch, cr, ref, gen, *hop_chunks(cfg, C)),
               check_dequant_add(torch, cr, ref, compression, gen, cfg.d_model * cfg.d_ff)]
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 3: serve the full-width model through the port's entry points.
    counts, metrics = serve(torch, card)
    log(f"[serve] metrics {json.dumps(metrics)} on {card}")
    gc.collect()
    torch.cuda.empty_cache()  # the engine's 30 GB go back before the ranks start

    # Phase 4: the cross-pod gradient sync on rank processes sharing the card.
    summary = sync(torch, card)
    log(f"[sync] metrics {json.dumps(summary)} on {card}")
    launches = dict(counts, chunk_reduce=sum(summary["methods"]["hoplite_chain"]["chunk_reduce"]),
                    flash_attention=counts["flash_attention_tc"])  # the serve path's route
    for r in records:
        r["launches"] = launches[r["name"]]

    # Phase 5 and 6: the kernels record, then the result.
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
