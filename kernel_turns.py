"""Kernels in turns on one NVIDIA GPU: this tree's against builds of other sources.

    python3 kernel_turns.py [rmsnorm] --baseline build/rmsnorm_base.cu [--baseline build/other.cu ...]
    python3 kernel_turns.py flash --baseline build/flash_f32_base.cu

``rmsnorm`` (the default mode):

Times the RMSNorm kernels built from each ``--baseline`` against this
tree's, in turns (the baselines, this tree's, ``F.rms_norm``, ``F.rms_norm``,
this tree's, the baselines in reverse) for ``--rounds`` rounds under
``chip_smoke.time_ms``, at the serve path's shapes in bf16: (2048, 5120),
(81920, 128), (16384, 128), the decode row (4, 5120) and the least call,
(1, 128); then at (2048, 5120) a view of x one element past a 16-byte
boundary (this tree's scalar path).  Each build is first held to the plain
version.  At (2048, 5120) it also times each variant with its write-back
inside the window: ``time_ms``'s read flush, which leaves the L2 clean,
lets a kernel's output stay in the L2 past the window's end, so a second
round of turns times windows that hold the call and then the read flush,
less windows that hold the flush alone.

The baseline is a source of the kernel with the same C interface
(``rmsnorm_fwd``), for instance an earlier commit's, written under the
ignored ``build/`` first:

    git show <commit>:src/repro_torch/kernels/csrc/rmsnorm.cu > build/rmsnorm_base.cu

``flash``: the f32 flash forward (``csrc/flash_attention.cu``) built from
each ``--baseline`` against this tree's, with SDPA in f32 as the yardstick
(``torch.backends.cuda.matmul.allow_tf32`` False, so its products stay in
f32), in turns in the same order, at the serve_f32 phase's prefill shape
(q (4, 40, 512, 128), kv (4, 8, 512, 128), causal, no lse) and at the train
shape (q (1, 40, 4096, 128), causal, with the lse).  Each build is first held
to the plain version at 2e-5, output and lse.  Each time is printed beside
two bounds: three TF32 products on the tensor cores (the design of this
tree's kernel) and one f32 product on the CUDA cores.  The baseline is a
source with the same C interface (``flash_attention_fwd``), for instance:

    git show 453b9ee:src/repro_torch/kernels/csrc/flash_attention.cu > build/flash_f32_base.cu

Each baseline is built with ``_build.NVCC_FLAGS`` into
``build/kernel_turns/`` and loaded with ctypes.  Each variant's times are the
medians of its turns (each turn the median of 20 CUDA-event runs), with their
range; the script prints them with the card's name and power limit and
writes them as JSON to ``--out`` (by default
``build/kernel_turns/<mode>.json``).  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))

# (shape, elements past a 16-byte boundary): the serve path's shapes, aligned;
# (1, 128), the least call, shows what a launch costs on its own under the
# flush; then a misaligned view.
RMSNORM_CASES = (((2048, 5120), 0), ((81920, 128), 0), ((16384, 128), 0), ((4, 5120), 0), ((1, 128), 0),
                 ((2048, 5120), 1))


def log(msg: str) -> None:
    print(msg, flush=True)


def build_baseline(source: Path) -> ctypes.CDLL:
    """The library built from ``source`` with ``_build.NVCC_FLAGS``, loaded."""
    from repro_torch.kernels import _build

    src = source.read_bytes()
    out = HERE / "build" / "kernel_turns" / hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = out / f"lib{source.stem}.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(source)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
        regs = [line.strip() for line in (r.stdout + r.stderr).splitlines() if "registers" in line or "spill" in line]
        log(f"[build] {source}: " + "; ".join(regs))
    return ctypes.CDLL(str(lib))


def baseline_rmsnorm(torch, source: Path):
    """``rmsnorm(x, w)`` through the kernel built from ``source``."""
    from repro_torch.kernels import rmsnorm as rn

    fn = build_baseline(source).rmsnorm_fwd
    fn.argtypes = rn.ARGTYPES
    fn.restype = ctypes.c_int

    def rmsnorm(x, w, eps: float = 1e-6):
        out = torch.empty_like(x)
        d = x.shape[-1]
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d, d, eps, rn._DTYPES[x.dtype],
                 rn._DTYPES[w.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline rmsnorm launch failed: cudaError {err}")
        return out

    return rmsnorm


def time_through_flush(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """``fn``'s device time with its write-back inside the window: the median
    of windows that hold ``fn`` and then ``chip_smoke.time_ms``'s read flush,
    less the median of windows that hold the flush alone, each window
    opened as ``time_ms`` opens it (the read flush, then the spin)."""
    import chip_smoke as CS

    flush = torch.zeros(CS.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    with_fn, alone = [], []
    for _ in range(reps):
        for fns, times in (((fn,), with_fn), ((), alone)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.sum(flush, 0, out=total)
            torch.cuda._sleep(CS.SPIN_CYCLES)
            start.record()
            for f in fns:
                f()
            torch.sum(flush, 0, out=total)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(with_fn) - statistics.median(alone)


def turns(order, timers: dict, rounds: int) -> dict:
    """Each round times the variants in ``order`` (names of ``timers``, each
    a function returning one time); per variant the median, range and every
    time."""
    got = {name: [] for name in timers}
    for _ in range(rounds):
        for name in order:
            got[name].append(timers[name]())
    return {name: {"median_ms": statistics.median(t), "min_ms": min(t), "max_ms": max(t), "ms": t}
            for name, t in got.items()}


def run_rmsnorm(torch, gen, bases: dict, rounds: int) -> list:
    import chip_smoke as CS
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    out = []
    order = (*bases, "new", "F.rms_norm", "F.rms_norm", "new", *reversed(bases))
    for shape, offset in RMSNORM_CASES:
        d = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(d, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        w1 = 1.0 + w
        want = ref.rmsnorm_ref(x, w)
        if offset:
            x = torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")[offset:].view(shape).copy_(x)
        what = f"{shape} bf16" + (f", x {x.data_ptr() % 16} bytes past 16" if offset else "")
        fns = {**bases, "new": rn.rmsnorm, "F.rms_norm": lambda x, w: torch.nn.functional.rms_norm(x, (d,), w1, 1e-6)}
        for name in (*bases, "new"):
            CS.compare(torch, f"rmsnorm {what}, {name}", fns[name](x, w), want, "bfloat16")
        b_ms, b_by = CS.bound(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), "bfloat16")
        timings = [("time_ms", CS.time_ms)]
        if (shape, offset) == RMSNORM_CASES[0]:
            timings.append(("the write-back inside the window", time_through_flush))
        for how, timer in timings:
            r = turns(order, {name: (lambda f=f, timer=timer: timer(torch, lambda: f(x, w))) for name, f in fns.items()},
                      rounds)
            parts = [f"{name} median {t['median_ms']:.6f} ms (range {t['min_ms']:.6f}-{t['max_ms']:.6f}, "
                     f"{100 * b_ms / t['median_ms']:.1f}% of the bound)" for name, t in r.items()]
            ratios = [f"new / {name} {r['new']['median_ms'] / r[name]['median_ms']:.4f}"
                      for name in (*bases, "F.rms_norm")]
            log(f"[rmsnorm] {what}, {how}, {2 * rounds} turns each: " + "; ".join(parts) + "; " + ", ".join(ratios) +
                f"; bound {b_ms:.6f} ms ({b_by})")
            out.append({"shape": list(shape), "dtype": "bfloat16", "elements_past_16_bytes": offset, "timing": how,
                        "bound_ms": b_ms, "bound_by": b_by, **r})
    return out


def baseline_flash(torch, source: Path):
    """``flash(q, k, v, causal, lse)`` through the f32 kernel built from
    ``source``: ``(out, lse or None)``."""
    from repro_torch.kernels import flash_attention as fa

    fn = build_baseline(source).flash_attention_fwd
    fn.argtypes = fa.ARGTYPES["flash_attention_fwd"]
    fn.restype = ctypes.c_int

    def flash(q, k, v, causal: bool, lse: bool):
        B, H, Sq, D = q.shape
        out = torch.empty_like(q)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if lse else None
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if l is None else l.data_ptr(),
                 B, H, k.shape[1], Sq, k.shape[2], D, int(causal), 0, 0, 1.0 / D ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline flash launch failed: error {err}")
        return out, l

    return flash


# (B, H, Kh, S, D, causal, with the lse): the serve_f32 phase's prefill, the train shape.
FLASH_CASES = ((4, 40, 8, 512, 128, True, False), (1, 40, 8, 4096, 128, True, True))


def run_flash(torch, gen, bases: dict, rounds: int) -> list:
    import chip_smoke as CS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = []
    order = (*bases, "new", "SDPA f32", "SDPA f32", "new", *reversed(bases))
    for B, H, Kh, S, D, causal, lse in FLASH_CASES:
        q, k, v = CS.flash_inputs(torch, gen, B, H, Kh, S, S, D, torch.float32)
        want = ref.flash_attention_ref(q, k, v, causal, 0, 0, return_lse=True)
        what = f"q {(B, H, S, D)} kv {(B, Kh, S, D)} causal f32{' with lse' if lse else ''}"
        fns = {**{name: (lambda f=f: f(q, k, v, causal, lse)) for name, f in bases.items()},
               "new": lambda: fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=lse),
               "SDPA f32": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                                     enable_gqa=True)}
        for name in (*bases, "new"):
            got = fns[name]()
            got_out, got_lse = got if isinstance(got, tuple) else (got, None)
            CS.compare(torch, f"flash {what}, {name}", got_out, want[0], "float32")
            if got_lse is not None:
                CS.compare(torch, f"flash {what}, {name}, lse", got_lse, want[1], "float32")
        del want
        ops = 4 * B * H * D * CS.flash_pairs(torch, S, S, causal, 0, 0)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + (B * H * S * 4 if lse else 0)
        b_ms, b_by = CS.bound(nbytes, CS.F32_FLASH_PRODUCTS * ops, "tf32")
        core_ms, core_by = CS.bound(nbytes, ops, "float32")
        r = turns(order, {name: (lambda f=f: CS.time_ms(torch, f)) for name, f in fns.items()}, rounds)
        parts = [f"{name} median {t['median_ms']:.6f} ms (range {t['min_ms']:.6f}-{t['max_ms']:.6f}, "
                 f"{100 * b_ms / t['median_ms']:.1f}% of the bound)" for name, t in r.items()]
        ratios = [f"new / {name} {r['new']['median_ms'] / r[name]['median_ms']:.4f}" for name in (*bases, "SDPA f32")]
        log(f"[flash] {what}, {2 * rounds} turns each: " + "; ".join(parts) + "; " + ", ".join(ratios) +
            f"; bound {b_ms:.6f} ms ({b_by}: {CS.F32_FLASH_PRODUCTS} TF32 products of {ops / 1e9:.3f} GFLOP each); "
            f"CUDA-core bound {core_ms:.6f} ms ({core_by}); SDPA with allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}")
        out.append({"shape": what, "bound_ms": b_ms, "bound_by": b_by, "cuda_core_bound_ms": core_ms,
                    "cuda_core_bound_by": core_by, "sdpa_allow_tf32": torch.backends.cuda.matmul.allow_tf32, **r})
        del q, k, v
    return out


MODES = {"rmsnorm": (baseline_rmsnorm, run_rmsnorm), "flash": (baseline_flash, run_flash)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", choices=sorted(MODES), default="rmsnorm")
    p.add_argument("--baseline", type=Path, action="append", required=True,
                   help="a source of the mode's kernel (rmsnorm_fwd or flash_attention_fwd); named by its "
                        "file's stem")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, help="the JSON record (default build/kernel_turns/<mode>.json)")
    args = p.parse_args(argv)
    make_baseline, run = MODES[args.mode]

    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bases = {path.stem: make_baseline(torch, path) for path in args.baseline}
    records = run(torch, gen, bases, args.rounds)
    out = args.out or HERE / "build" / "kernel_turns" / f"{args.mode}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "mode": args.mode, "baselines": [str(b) for b in args.baseline],
                               "rounds": args.rounds, "records": records}, indent=1))
    log(f"[card] {card}; records in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
