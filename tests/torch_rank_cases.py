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
