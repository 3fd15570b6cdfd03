"""Rank code of the port's multi-rank tests, run in the processes that
``repro_torch.core.group.run_ranks`` spawns (tests/test_torch_collectives.py on
the CPU, tests/test_torch_gpu.py on the card).  It imports only the port, and
torch and numpy: a rank process never loads JAX.

Each function runs every case in one process group and returns the outputs,
so a test file pays for one spawn.  Beside each output it records how many
``group.exchange`` steps and ``ops.chunk_reduce`` hops the case made in this
rank (counted by wrapping both functions in this process), how many
kernel launches ``ops.launch_counts`` saw, and where the output lay.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import collectives as C
from repro_torch.core import group as G
from repro_torch.kernels import ops
from repro_torch.launch import train as LT
from repro_torch.tree import leaves
from repro_torch.train.step import TrainOptions, _pod_sync_fn, make_train_step

GRAD_METHODS = ("psum", "hoplite", "chain", "chain2d", "rs_ag")
POD_SYNCS = ("hoplite_chain", "hoplite_2d", "psum")


class _Recorder:
    """Outputs and per-case counts of one rank."""

    def __init__(self):
        self.out, self.calls = {}, {}
        self._n = {"exchange": 0, "chunk_reduce": 0}
        exchange, chunk_reduce = G.exchange, ops.chunk_reduce

        def counted_exchange(*a, **k):
            self._n["exchange"] += 1
            return exchange(*a, **k)

        def counted_chunk_reduce(*a, **k):
            self._n["chunk_reduce"] += 1
            return chunk_reduce(*a, **k)

        G.exchange, ops.chunk_reduce = counted_exchange, counted_chunk_reduce

    def case(self, name, fn):
        self._n.update(exchange=0, chunk_reduce=0)
        ops.reset_launch_counts()
        self.out[name] = fn()
        self.calls[name] = dict(self._n, launches=ops.launch_counts()["chunk_reduce"],
                                devices=sorted({t.device.type for t in leaves(self.out[name])}))

    def result(self):
        return {"out": self.out, "calls": self.calls}


def _tree(x: np.ndarray, r: int, dev):
    return {"a": torch.from_numpy(x[r:r + 1]).to(dev),
            "b": torch.from_numpy(x[r:r + 1, :17] * 2).to(dev)}


def collective_cases(dev, x: np.ndarray, xx: np.ndarray, ref_config: C.CollectiveConfig):
    """The cases of tests/test_collectives_multidev.py and more, on 8 ranks:
    ``x`` (8, 1536) holds row r for rank r; ``xx`` (2, 4, 32) feeds the four
    pairs (i, i + 4) that make groups of n = 2; ``ref_config`` carries the
    reference's ICI link values where a schedule's dispatch depends on them."""
    r = dist.get_rank()
    rec = _Recorder()
    a = torch.from_numpy(x[r:r + 1]).to(dev)
    for c in (4, 16):
        rec.case(f"chain_allreduce/{c}", lambda c=c: C.chain_allreduce(a, None, c))
    rec.case("two_level_allreduce/4", lambda: C.two_level_allreduce(a, None, 4))
    rec.case("rs_ag_allreduce", lambda: C.rs_ag_allreduce(a))
    rec.case("hoplite_psum", lambda: C.hoplite_psum(a, None, ref_config))
    rec.case("chain_reduce/4", lambda: C.chain_reduce(a, None, 4))
    y = torch.full((1, 64), 2.5 if r == 7 else 0.0, device=dev)
    rec.case("chain_broadcast/last", lambda: C.chain_broadcast(y, None, 4))
    y0 = torch.full((1, 64), -1.5 if r == 0 else 0.0, device=dev)
    rec.case("chain_broadcast/first", lambda: C.chain_broadcast(y0, None, 4, root="first"))
    for root in (0, 3, 7):
        z = torch.full((1, 16), root + 1.0 if r == root else 0.0, device=dev)
        rec.case(f"binomial_broadcast/{root}", lambda z=z, root=root: C.binomial_broadcast(z, None, root))

    pairs = [dist.new_group([i, i + 4]) for i in range(4)]  # every rank makes every group
    pair = pairs[r % 4]
    b = torch.from_numpy(xx[r // 4, r % 4][None]).to(dev)
    rec.case("n2/chain_allreduce", lambda: C.chain_allreduce(b, pair, 8))
    rec.case("n2/two_level_allreduce", lambda: C.two_level_allreduce(b, pair, 4))
    rec.case("n2/rs_ag_allreduce", lambda: C.rs_ag_allreduce(b, pair))
    rec.case("n2/chain_reduce", lambda: C.chain_reduce(b, pair, 4))

    tree = _tree(x, r, dev)
    for method in GRAD_METHODS:
        rec.case(f"grad_sync/{method}", lambda m=method: C.grad_sync(tree, None, m, ref_config))
    for pod_sync in POD_SYNCS:
        for comp in (False, True):
            sync = _pod_sync_fn(TrainOptions(pod_sync=pod_sync, pod_compression=comp))
            rec.case(f"pod_sync/{pod_sync}/{'int8' if comp else 'raw'}", lambda s=sync: s(tree))
    return rec.result()


def card_cases(dev, x: np.ndarray):
    """A few allreduces of ``x`` (n, 1536), row r on rank r, with the launches
    of the hop kernel that each made in this rank."""
    r = dist.get_rank()
    rec = _Recorder()
    a = torch.from_numpy(x[r:r + 1]).to(dev)
    rec.case("chain_allreduce/4", lambda: C.chain_allreduce(a, None, 4))
    rec.case("two_level_allreduce/4", lambda: C.two_level_allreduce(a, None, 4))
    rec.case("rs_ag_allreduce", lambda: C.rs_ag_allreduce(a))
    rec.case("pod_sync/hoplite_chain/raw", lambda: _pod_sync_fn(TrainOptions())(_tree(x, r, dev)))
    return rec.result()


def train_pod_steps(dev, state_np, batches, options: TrainOptions):
    """Train steps of reduced qwen3-14b with every rank a pod: rank r takes
    its share of each global batch (numpy) as the launcher does, the block
    that ``batch_specs``' placements give pod coordinate r on
    ``launch.train.pod_mesh``; the gradients meet by ``options.pod_sync``
    over the world group.  Returns the state and the metrics of each step."""
    r, n = dist.get_rank(), dist.get_world_size()
    cfg = reduced_config(get_config("qwen3-14b"))
    state = convert.state_from_jax(state_np, cfg, dev)
    step = make_train_step(cfg, options, pod=dist.group.WORLD)
    metrics = []
    for b in batches:
        shape = ShapeSpec("pods", b["tokens"].shape[1], b["tokens"].shape[0], "train")
        mine = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in LT.pod_share(cfg, shape, options, LT.pod_mesh(n), r, b).items()}
        state, m = step(state, mine)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": state, "metrics": metrics}


def fail_on_rank_1(dev):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return dist.get_rank()


def hang(dev):
    time.sleep(600)


def _seeded_make(seed: int, vocab: int, made: list):
    """``dryrun.build_cell``'s ``make``: each tensor whole, the same on every
    rank (one generator, one order), kept in ``made``: floats in f32 (the
    bf16 parameters of the skeleton too, so that 1e-5 can hold), uniform in
    [0, 0.1); integers (tokens, labels, positions) below ``vocab``; a scalar
    count 0."""
    gen = torch.Generator().manual_seed(seed)

    def make(shape, dtype):
        if not dtype.is_floating_point:
            t = (torch.zeros(shape, dtype=dtype) if not shape
                 else torch.randint(0, vocab, shape, generator=gen).to(dtype))
        else:
            t = torch.rand(shape, generator=gen) * 0.1
        made.append(t)
        return t

    return make


def _plant_wrong_gqa_rule():
    """A wrong GQA rule: q keeps its heads split over the model axis while k
    and v are gathered, and the flash ops accept that split.  The kernel's
    h // G then reads the wrong kv head on every device but the first."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn

    heads = attn._heads

    def wrong(t, kv_heads, shape):
        # q (five dims) keeps its split; k and v are gathered (3 divides no split)
        return t.reshape(shape) if len(shape) == 5 else heads(t, 3, shape)

    def wrong_singles(n):
        # first: q (and the outputs) split on heads, k and v whole
        right = ops._flash_singles(n)
        return lambda *specs: [[Shard(1)] * n + [Shard(1), Replicate(), Replicate()] + [None] * 3] + right(*specs)

    attn._heads = wrong
    for op, n in ((torch.ops.repro_torch.flash_attention_fwd.default, 1),
                  (torch.ops.repro_torch.flash_attention_fwd_lse.default, 2)):
        ops.register_rule(op, n, wrong_singles(n), None)

    def undo():
        attn._heads = heads
        for op, n in ((torch.ops.repro_torch.flash_attention_fwd.default, 1),
                      (torch.ops.repro_torch.flash_attention_fwd_lse.default, 2)):
            ops.register_rule(op, n, ops._flash_singles(n), ops._heads_split_together)
        DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()

    return undo


def one_block(cfg):
    """A reduced config cut to the first three layers of its pattern, no tail,
    and one encoder layer: each config's every layer kind (jamba's attention,
    Mamba with the MoE and Mamba with the FFN), once."""
    import dataclasses

    pattern = cfg.pattern[:3]
    return dataclasses.replace(cfg, pattern=pattern, tail_pattern=(), num_layers=len(pattern),
                               encoder_layers=min(cfg.encoder_layers, 1))


def _whole(tree):
    """Every DTensor of a tree gathered (collective: every rank calls it)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def dtensor_program_cases(dev, cases, seed: int):
    """The DTensor program the dry run traces (``dryrun.build_cell``), run on
    the debug meshes of the 8 ranks with real tensors, and the same step in
    one process on the whole tensors.  ``cases``: (name, arch, mesh kind,
    shape kind, planted) with planted True for a run under
    ``_plant_wrong_gqa_rule`` (run first: nothing of the real rule is cached
    yet).  Rank 0 returns {name: {"sharded": ..., "plain": ...}} of numpy
    arrays: prefill's logits and caches, decode's logits, the train step's
    loss, gradient norm and updated parameters."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import step as TS
    from repro_torch.tree import unflatten_like

    torch.set_num_threads(1)  # eight ranks on the CPU's cores: one thread each
    meshes = {"single": M.make_debug_mesh(), "multi": M.make_debug_mesh(multi_pod=True)}
    shapes = {"train": ShapeSpec("train", 8, 16, "train"), "prefill": ShapeSpec("prefill", 8, 16, "prefill"),
              "decode": ShapeSpec("decode", 8, 16, "decode")}
    # two microbatches a train step (each device's 4 rows split in two), not
    # the dry run's four: the microbatch path at half the operations
    D.micro_batches_for = lambda cfg, shape: 2 if shape.kind == "train" else 1
    out = {}
    for name, arch, mesh_kind, kind, planted in cases:
        cfg = one_block(reduced_config(get_config(arch)))
        shape = shapes[kind]
        made = []
        undo = _plant_wrong_gqa_rule() if planted else None
        try:
            with D._variant_restored():
                fn, args = D.build_cell(cfg, shape, meshes[mesh_kind], "hoplite_chain",
                                        make=_seeded_make(seed, cfg.vocab_size, made))
                plain_args = unflatten_like(args, [t.clone() for t in made])
                with implicit_replication():
                    got = _whole(fn(*args))
        finally:
            if undo is not None:
                undo()
        if kind == "train":
            opts = TrainOptions(num_microbatches=D.micro_batches_for(cfg, shape), remat="full", pod_sync="gspmd")
            want = TS.make_train_step(cfg, opts)(*plain_args)
            pick = lambda res: {"loss": res[1]["loss"], "grad_norm": res[1]["grad_norm"],
                                "params": res[0]["params"]}
        elif kind == "prefill":
            want = T.prefill(cfg, plain_args[0], plain_args[1], cache_seq=shape.seq_len)
            pick = lambda res: {"logits": res[0], "caches": res[1]}
        else:
            want = T.decode_step(cfg, plain_args[0], plain_args[1], shape.seq_len - 1, plain_args[2])
            pick = lambda res: {"logits": res[0]}
        if dist.get_rank() == 0:
            out[name] = {"sharded": _as_numpy(pick(got)), "plain": _as_numpy(pick(want))}
    return out if dist.get_rank() == 0 else None


def _as_numpy(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t, tree)


# ---------------------------------------------------------------------------
# the staged backend and the mesh program
# ---------------------------------------------------------------------------

STAGED_DTYPES = (torch.float32, torch.bfloat16)


def _a2a_splits(n: int, r: int):
    """Uneven all-to-all: rank r sends (i + r) % 3 + 1 rows to rank i."""
    send = [(i + r) % 3 + 1 for i in range(n)]
    recv = [(r + i) % 3 + 1 for i in range(n)]
    return send, recv


def staged_collective_cases(dev, seed: int):
    """Every kind of collective a DTensor program issues, through the
    ``staged`` world group on ``dev``'s tensors (the functional collectives
    DTensor calls, and ``dist``'s), and the same on gloo's own group over
    host copies of the same inputs: f32 and bf16, blocks of 7 rows and an
    uneven all-to-all.  Also a DTensor split unevenly (13 rows on 4 ranks)
    made whole.  Returns {case: (staged, gloo)} as host tensors, and the
    staged group's counts."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    r, n = dist.get_rank(), dist.get_world_size()
    gloo = dist.new_group(backend="gloo")
    world = dist.group.WORLD
    rng = np.random.default_rng(seed + r)
    out = {}
    G.reset_collective_counts()
    for dt in STAGED_DTYPES:
        name = str(dt).removeprefix("torch.")
        x = torch.from_numpy(rng.standard_normal((7 * n, 5)).astype(np.float32)).to(dt)
        xd, xh = x.to(dev), x.clone()

        ag = funcol.all_gather_tensor(xd, 0, world).wait()
        want = torch.empty((7 * n * n, 5), dtype=dt)
        dist.all_gather_into_tensor(want, xh, group=gloo)
        out[f"all_gather/{name}"] = (ag.cpu(), want)

        rs = funcol.reduce_scatter_tensor(xd, "sum", 0, world).wait()
        want = torch.empty((7, 5), dtype=dt)
        dist.reduce_scatter_tensor(want, xh, group=gloo)
        out[f"reduce_scatter/{name}"] = (rs.cpu(), want)

        ar = funcol.all_reduce(xd, "sum", world).wait()
        want = xh.clone()
        dist.all_reduce(want, group=gloo)
        out[f"all_reduce/{name}"] = (ar.cpu(), want)

        send, recv = _a2a_splits(n, r)
        y = torch.from_numpy(rng.standard_normal((sum(send), 3)).astype(np.float32)).to(dt)
        a2a = funcol.all_to_all_single(y.to(dev), recv, send, world).wait()
        want = torch.empty((sum(recv), 3), dtype=dt)
        dist.all_to_all_single(want, y, recv, send, group=gloo)
        out[f"all_to_all/{name}"] = (a2a.cpu(), want)

        inplace = xd.clone()
        dist.all_reduce(inplace)  # dist's own call on the staged group
        out[f"dist.all_reduce/{name}"] = (inplace.cpu(), out[f"all_reduce/{name}"][1])
        lst = [torch.empty_like(xd) for _ in range(n)]
        dist.all_gather(lst, xd)
        out[f"dist.all_gather/{name}"] = (torch.cat(lst).cpu(), out[f"all_gather/{name}"][1])
        b = xd.clone()
        dist.broadcast(b, src=3)
        want = xh.clone()
        dist.broadcast(want, src=3, group=gloo)
        out[f"broadcast/{name}"] = (b.cpu(), want)

    mesh = init_device_mesh(dev.type, (n // 2, 2), mesh_dim_names=("data", "model"))
    whole = torch.from_numpy(np.random.default_rng(seed).standard_normal((13, 6)).astype(np.float32))
    d = DTensor.from_local(whole.chunk(n // 2)[mesh.get_coordinate()[0]].to(dev), mesh,
                           [Shard(0), Replicate()], run_check=False, shape=whole.shape,
                           stride=whole.stride())
    out["dtensor_uneven/float32"] = (d.full_tensor().cpu(), whole)
    try:  # an operation the staged group lacks
        dist.gather(xd, [torch.empty_like(xd) for _ in range(n)] if r == 0 else None, dst=0)
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    return {"cases": out, "counts": G.collective_counts(), "refused": refused}


def restore_gathered(dev, directory: str, arch: str, mesh_dims):
    """Reduced ``arch``'s train state restored from ``directory`` onto a mesh
    of ``mesh_dims`` (data, model), each rank reading its own blocks, then
    gathered whole to rank 0 (``launch.train.gather_state``): rank 0 returns
    (step, state), the others ``None``."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import placement
    from repro_torch.train import step as TS

    cfg = reduced_config(get_config(arch))
    mesh = make_mesh(tuple(mesh_dims), ("data", "model"), dev)
    step, state = Checkpointer(directory).restore(TS.abstract_state(cfg),
                                                  placements=placement.shardings(TS.state_specs(cfg, mesh), mesh))
    whole = LT.gather_state(state)
    return (step, whole) if dist.get_rank() == 0 else None


def placed_devices(dev, arch: str):
    """Reduced ``arch`` on the (4, 2) debug mesh of ``dev``: the state placed
    by ``init_state``, a batch by the pipeline, the caches of a prefill; the
    device types of every local block, the most whole leaves a rank held
    while the state was placed, and whether ``check_on_mesh`` refused a block
    from the other device."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.placement import check_on_mesh
    from repro_torch.data import pipeline
    from repro_torch.serving.engine import Engine, ServeOptions
    from repro_torch.sharding import partitioning, placement
    from repro_torch.train import step as TS

    cfg = reduced_config(get_config(arch))
    mesh = make_debug_mesh(device=dev)
    placement.reset_whole_leaves()
    state = TS.init_state(cfg, 0, dev, mesh=mesh)
    held = placement.whole_leaves_held()["most"]
    shape = ShapeSpec("t", 8, 4, "train")
    batch = pipeline.device_batch(cfg, shape, 0, dev, mesh=mesh,
                                  specs=partitioning.batch_specs(cfg, mesh, shape))
    eng = Engine(cfg, state["params"], ServeOptions(max_seq=16, batch_size=4), mesh=mesh)
    with eng._program(4):
        _, caches = eng.prefill_fn(eng._inputs({"tokens": np.zeros((4, 8), np.int32)}))
    types = {name: sorted({(t.to_local() if isinstance(t, DTensor) else t).device.type
                           for t in leaves(tree) if isinstance(t, torch.Tensor)})
             for name, tree in (("state", state), ("batch", batch), ("caches", caches))}
    other = torch.zeros(2, device="cpu" if dev.type == "cuda" else "meta")
    try:
        check_on_mesh(other, mesh)
        refused = False
    except RuntimeError:
        refused = True
    return {"types": types, "whole_leaves_held": held, "refused": refused, "mesh_device": mesh.device_type}
