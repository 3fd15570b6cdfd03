"""Dry run of every (arch x shape x mesh) cell on a fake mesh (port of
``repro.launch.dryrun``).

The JAX dry run lowers and compiles each cell on 512 forced host devices and
reads XLA's memory and cost analyses.  The port has no compiler to ask, so
it runs each cell's real step (the train step, prefill or one decode step)
once, on DTensor inputs placed by the JAX rules (``sharding.partitioning``)
on ``launch.mesh.fake_mesh``, under ``FakeTensorMode``: nothing is allocated
and no device is touched.  The process is rank 0 of torch's ``fake``
backend, whose collectives move nothing, so every local shape is rank 0's
(every split of these cells divides, so each device holds as much).  Per
cell it records, per device:

  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``,
    the local bytes of the inputs and outputs; ``peak_bytes``, the most
    bytes live at once by ``MemTracker`` (the arguments included); and
    ``temp_size_in_bytes`` = peak - arguments, the counterpart of XLA's
    temp (the in-place state update writes no second copy of the state);
  * ``cost``, ``walker`` and ``collectives``: ``launch.op_cost`` over the
    step (FLOPs per device and of the unsharded program, unfused bytes,
    collectives by kind with their ring link bytes);
  * ``attention_placements``: the placements q had in each flash call
    (an attention replicated over the model axis shows here);
  * ``trace_s``: the cell's time, set-up and trace.

The multi-pod train cells run as the JAX step does under its ``shard_map``:
the state and the pod's share of the batch on the (data, model) sub-mesh,
the gradients synced over the "pod" sub-group by ``--pod-sync`` on each
device's local block (``hoplite_chain`` by default); ``--pod-sync gspmd``
runs the step on the whole mesh, where DTensor reduces over the pod axis.
Every number is traced, with no device: none is a time or a rate.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--pod-sync hoplite_chain] [--variant V]
        [--force] [--out DIR]

writes one JSON record per cell under ``DIR`` (``build/dryrun`` by
default), in the JAX dry run's sub-directories, never under ``artifacts/``.
A failure in any cell is a bug in the system: the cell prints FAIL and the
dry run exits non-zero at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCHS, get_config, shapes_for
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import link_bytes  # noqa: F401  (parse_collectives' ring formulas)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.sharding import partitioning, placement
from repro_torch.train import step as TS
from repro_torch.tree import leaves, tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

VARIANT_FLAGS = ("bf16partials", "moedrop", "rematdots", "micro4", "micro8", "micro32", "podcompress")


def micro_batches_for(cfg, shape) -> int:
    """Keep per-device microbatch ~1 row for big models (memory bound)."""
    if shape.kind != "train":
        return 1
    big = cfg.param_count() > 10e9
    return 16 if big else 4


def apply_variant(variant: str) -> Dict[str, Any]:
    """Perf-iteration knobs, comma-separated flags, as the JAX dry run's:
    bf16partials (``common.set_matmul_partial_dtype(bfloat16)``), moedrop
    (``moe.set_moe_mode("dropping")``), and rematdots, micro4, micro8,
    micro32, podcompress (read by ``build_cell``)."""
    applied = {}
    for f in [f for f in variant.split(",") if f] if variant else []:
        if f == "bf16partials":
            C.set_matmul_partial_dtype(torch.bfloat16)
        elif f == "moedrop":
            M.set_moe_mode("dropping")
        elif f not in VARIANT_FLAGS:
            raise ValueError(f"unknown variant flag {f!r}")
        applied[f] = True
    return applied


@contextlib.contextmanager
def _variant_restored():
    """The process-global knobs ``apply_variant`` sets, as they were after."""
    partial, mode = C.MATMUL_PARTIAL_DTYPE[0], M.MOE_MODE[0]
    act = dict(T.ACTIVATION_SHARDING)
    try:
        yield
    finally:
        C.set_matmul_partial_dtype(partial)
        M.set_moe_mode(mode)
        T.ACTIVATION_SHARDING.update(act)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype)


def _place(t: torch.Tensor, spec, full_mesh, on_mesh, make: Callable) -> DTensor:
    """``placement.place`` with every rank making the whole tensor by
    ``make(shape, dtype)`` (under ``FakeTensorMode`` nothing is allocated)."""
    return placement.place(t, spec, full_mesh, lambda: make(tuple(t.shape), t.dtype), source="each", on=on_mesh)


def _place_tree(tree, specs, full_mesh, on_mesh, make):
    return placement.place_tree(tree, specs, full_mesh, lambda t: make(tuple(t.shape), t.dtype), source="each",
                                on=on_mesh)


def build_cell(cfg, shape, mesh, pod_sync: str, variant: str = "", make: Optional[Callable] = None,
               microbatches: Optional[int] = None):
    """(step function, its inputs) of one cell on ``mesh``: DTensors placed by
    the JAX rules, made by ``make(shape, dtype)`` (``torch.empty`` by
    default: fakes under ``FakeTensorMode``).  The function is the port's
    own step on them: ``make_train_step``, ``prefill`` or ``decode_step``.
    ``microbatches`` overrides ``micro_batches_for`` (a run's own count)."""
    make = make or _empty
    shopts = partitioning.ShardingOptions()
    multi = "pod" in mesh.mesh_dim_names
    if shape.kind == "train":
        micro = microbatches or micro_batches_for(cfg, shape)
        for flag, n in (("micro4", 4), ("micro8", 8), ("micro32", 32)):
            if flag in variant:
                micro = n
        opts = TS.TrainOptions(num_microbatches=micro, remat="dots" if "rematdots" in variant else "full",
                               pod_sync=pod_sync if multi else "gspmd",
                               pod_compression="podcompress" in variant)
        manual_pod = multi and opts.pod_sync != "gspmd"
        on = mesh["data", "model"] if manual_pod else mesh
        state, batch = S.train_inputs(cfg, shape)
        pspecs = partitioning.param_specs(cfg, T.model_skel(cfg), mesh, shopts)
        scalar = partitioning.P()
        st_specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "count": scalar}, "step": scalar}
        state = _place_tree(state, st_specs, mesh, on, make)
        bspecs = partitioning.batch_specs(cfg, mesh, shape, shopts)
        batch = {k: _place(v, bspecs[k], mesh, on, make) for k, v in batch.items()}
        step = TS.make_train_step(cfg, opts, pod=mesh.get_group("pod") if manual_pod else None)
        return step, (state, batch)
    b_axes = partitioning._batch_axes(mesh, shape.global_batch, shopts)
    T.set_activation_sharding(b_axes, shopts.tp_axis)
    pspecs = partitioning.param_specs(cfg, T.model_skel(cfg), mesh, shopts)
    if shape.kind == "prefill":
        params, batch = S.prefill_inputs(cfg, shape)
        params = _place_tree(params, pspecs, mesh, mesh, make)
        bspecs = partitioning.batch_specs(cfg, mesh, shape, shopts)
        batch = {k: _place(v, bspecs[k], mesh, mesh, make) for k, v in batch.items()}
        return (lambda params, batch: T.prefill(cfg, params, batch, cache_seq=shape.seq_len)), (params, batch)
    params, token, t, caches = S.decode_inputs(cfg, shape)
    params = _place_tree(params, pspecs, mesh, mesh, make)
    token = _place(token, partitioning.token_batch_spec(mesh, shape.global_batch, shopts), mesh, mesh, make)
    caches = _place_tree(caches, partitioning.cache_specs(cfg, mesh, shape.global_batch, shopts), mesh, mesh, make)
    # the position of the new token: the last slot of the cache (a python int in the port's decode_step)
    pos = shape.seq_len - 1
    return (lambda params, token, caches: T.decode_step(cfg, params, token, pos, caches)), (params, token, caches)


def _local_bytes(tree) -> int:
    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _locals(tree):
    return [t.to_local() if isinstance(t, DTensor) else t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def trace_cell(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``MemTracker`` and ``op_cost``: the
    memory, cost and collectives of the record (the caller holds the fake
    mode and the mesh)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    arg_bytes = _local_bytes(args)
    attn.PLACEMENTS_SEEN.clear()
    mt = MemTracker()
    mt.track_external(*_locals(args))
    with op_cost.dtensor_beside_fake_mode(), mt, implicit_replication(), op_cost.count() as cost:
        out = fn(*args)
    # the arguments' device: tensors made on "meta" (shapes only) are no device's
    device = next(iter(_locals(args))).device
    peak = mt.get_tracker_snapshot("peak").get(device, {}).get("Total", 0)
    walk = cost.analyze()
    return {
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": _local_bytes(out),
                   "peak_bytes": peak, "temp_size_in_bytes": peak - arg_bytes},
        "cost": {"flops": walk["walker"]["flops"], "bytes accessed": walk["walker"]["bytes"]},
        "collectives": walk["collectives"],
        "walker": walk["walker"],
        "aten_ops": walk["ops"],
        "flops_by_op": walk["flops_by_op"],
        "attention_placements": sorted(attn.PLACEMENTS_SEEN),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, pod_sync: str = "hoplite_chain", force: bool = False,
             variant: str = "", out_dir: Optional[str] = None) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    sub = mesh_kind if not variant else f"{mesh_kind}-{variant.replace(',', '+')}"
    if pod_sync != "hoplite_chain":
        sub = f"{sub}-{pod_sync}"
    out_dir = os.path.join(os.path.abspath(out_dir or OUT_DIR), sub)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if cached.get("ok"):
            print(f"[cached] {mesh_kind}/{arch}/{shape_name}")
            return cached
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    record: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
                              "pod_sync": pod_sync, "variant": variant, "ok": False,
                              "traced": "no device: FakeTensorMode on the fake backend, rank 0's view"}
    t0 = time.time()
    try:
        with _variant_restored(), fake_mesh(multi_pod=mesh_kind == "multi") as mesh, FakeTensorMode():
            record["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
            record["num_devices"] = mesh.size()
            apply_variant(variant)
            fn, args = build_cell(cfg, shape, mesh, pod_sync, variant)
            record.update(trace_cell(fn, args))
        record.update(ok=True, trace_s=round(time.time() - t0, 2))
        mem, walk = record["memory"], record["walker"]
        print(f"[ok] {mesh_kind}/{arch}/{shape_name}: trace={record['trace_s']:.1f}s "
              f"peak={mem['peak_bytes'] / 2**30:.2f}GiB temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
              f"flops={walk['flops']:.3g} (global {walk['flops_global']:.3g}) "
              f"coll={walk['collective_link_bytes'] / 2**30:.2f}GiB", flush=True)
    except BaseException as e:  # noqa: BLE001
        if isinstance(e, KeyboardInterrupt):
            raise
        record["trace_s"] = round(time.time() - t0, 2)
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {mesh_kind}/{arch}/{shape_name}: {type(e).__name__}: {str(e)[:200]}", flush=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--pod-sync", default="hoplite_chain")
    ap.add_argument("--variant", default="", help="comma-separated perf flags")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None, help=f"record directory (default {os.path.normpath(OUT_DIR)})")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = [args.arch] if args.arch else sorted(ARCHS)
    failures = []
    for arch in archs:
        cell_shapes = [s.name for s in shapes_for(get_config(arch))]
        if args.shape:
            cell_shapes = [s for s in cell_shapes if s == args.shape]
        for shape_name in cell_shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape_name, mesh_kind, args.pod_sync, args.force, args.variant, args.out)
                if not rec.get("ok"):
                    failures.append((mesh_kind, arch, shape_name))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f_ in failures:
            print("  ", *f_)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
