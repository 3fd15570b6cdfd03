"""RMSNorm kernels in turns on one NVIDIA GPU: this tree's against builds of other sources.

    python3 kernel_turns.py --baseline build/rmsnorm_base.cu [--baseline build/other.cu ...]

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

It is built with ``_build.NVCC_FLAGS`` into ``build/kernel_turns/`` and
loaded with ctypes.  Each variant's times are the medians of its turns (each
turn the median of 20 CUDA-event runs), with their range; the script prints
them with the card's name and power limit and writes them as JSON to
``--out`` (by default ``build/kernel_turns/rmsnorm.json``).  Needs a CUDA
device and ``nvcc``.
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


def baseline_rmsnorm(torch, source: Path):
    """``rmsnorm(x, w)`` through the kernel built from ``source``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn

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
    fn = ctypes.CDLL(str(lib)).rmsnorm_fwd
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, action="append", required=True,
                   help="a source of the RMSNorm kernel (rmsnorm_fwd); named by its file's stem")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, help="the JSON record (default build/kernel_turns/rmsnorm.json)")
    args = p.parse_args(argv)

    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    card = CS.card_line()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bases = {path.stem: baseline_rmsnorm(torch, path) for path in args.baseline}
    records = run_rmsnorm(torch, gen, bases, args.rounds)
    out = args.out or HERE / "build" / "kernel_turns" / "rmsnorm.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "baselines": [str(b) for b in args.baseline],
                               "rounds": args.rounds, "records": records}, indent=1))
    log(f"[card] {card}; records in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
