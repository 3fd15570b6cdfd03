"""The port's dry run (``repro_torch.launch.dryrun`` and ``launch.op_cost``)
and the DTensor program it traces, on the CPU.

* Every cell's argument bytes per device against the JAX package's
  ``NamedSharding(mesh, spec).shard_shape`` sums on ``AbstractMesh`` (nothing
  is compiled), on both production meshes.
* rwkv6-1.6b ``decode_32k`` against the tracked JAX record, into a temporary
  directory: ``artifacts/`` is left as it was.
* The walker: the unsharded program's FLOPs (``flops_global``) against
  ``FlopCounterMode`` over the same step on plain tensors; per-device FLOPs
  of a flash call that splits and of one replicated over the model axis;
  the ring formulas against ``repro.launch.dryrun.parse_collectives``; f32
  and bf16 partial sums in the collectives' bytes.
* The custom ops (``torch.library.opcheck``), and the serve path's logits
  and kernel calls unchanged by them.
* ``apply_variant``'s flags against the JAX dry run's.
* The DTensor program on 8 gloo ranks (the debug meshes (4, 2) and (2, 2, 2),
  ``hoplite_chain`` over the pods), each cell built by ``build_cell`` with
  real tensors, against the same step in one process: 1e-5 relative in f32
  (the reductions run in another order, so not bit for bit); and a planted
  wrong GQA rule, which that check must fail.
"""

import json
import math
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding

from repro import configs as jconfigs
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.sharding import partitioning as JPT
from repro.train import step as JS

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402  (it sets XLA_FLAGS for its own process)

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import torch_rank_cases as cases  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec  # noqa: E402
from repro_torch.core import group as TG  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELLS = sorted(tconfigs.all_cells())
# The tracked JAX record of the cheapest cell, as tests/test_dryrun_smoke.py runs it.
JAX_RECORD = REPO / "artifacts" / "dryrun" / "single" / "rwkv6-1.6b__decode_32k.json"
# One H100's memory, 80 GB (NVIDIA's data sheet; PERF.md, "Where the time goes").
H100_BYTES = 80e9
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group"


# ---------------------------------------------------------------------------
# argument bytes, every cell, against JAX's shard shapes
# ---------------------------------------------------------------------------


def _jax_argument_bytes(arch: str, shape_name: str, multi: bool) -> int:
    """The sum of ``NamedSharding(mesh, spec).shard_shape`` bytes over the
    inputs the JAX dry run's ``build_cell`` places (the decode position ``t``,
    a Python int in the port, left out)."""
    cfg, shape = jconfigs.get_config(arch), JSHAPES[shape_name]
    m = tmesh.production_mesh_shape(multi_pod=multi)
    mesh = JAbstractMesh(m.shape, m.mesh_dim_names)
    opts = JPT.ShardingOptions()
    pspecs = JPT.param_specs(cfg, JT.model_skel(cfg), mesh, opts)
    pairs = []
    if shape.kind == "train":
        state, batch = jspecs.train_inputs(cfg, shape)
        sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "count": JPT.P()}, "step": JPT.P()}
        pairs += list(zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(
            sspecs, is_leaf=lambda s: isinstance(s, JPT.P))))
        bspecs = JPT.batch_specs(cfg, mesh, shape, opts)
        pairs += [(batch[k], bspecs[k]) for k in batch]
    elif shape.kind == "prefill":
        params, batch = jspecs.prefill_inputs(cfg, shape)
        pairs += list(zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
            pspecs, is_leaf=lambda s: isinstance(s, JPT.P))))
        bspecs = JPT.batch_specs(cfg, mesh, shape, opts)
        pairs += [(batch[k], bspecs[k]) for k in batch]
    else:
        params, token, _t, caches = jspecs.decode_inputs(cfg, shape)
        cspecs = JPT.cache_specs(cfg, mesh, shape.global_batch, opts)
        pairs += list(zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
            pspecs, is_leaf=lambda s: isinstance(s, JPT.P))))
        pairs.append((token, JPT.token_batch_spec(mesh, shape.global_batch, opts)))
        pairs += list(zip(jax.tree_util.tree_leaves(caches), jax.tree_util.tree_leaves(
            cspecs, is_leaf=lambda s: isinstance(s, JPT.P))))
    return sum(math.prod(NamedSharding(mesh, spec).shard_shape(a.shape)) * a.dtype.itemsize for a, spec in pairs)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_argument_bytes_equal_jax_shard_sums(arch, shape_name, multi):
    cfg, shape = tconfigs.get_config(arch), SHAPES_BY_NAME[shape_name]
    with D._variant_restored(), tmesh.fake_mesh(multi_pod=multi) as mesh, FakeTensorMode():
        _fn, args = D.build_cell(cfg, shape, mesh, "hoplite_chain")
        got = D._local_bytes(args)
    assert got == _jax_argument_bytes(arch, shape_name, multi)


# ---------------------------------------------------------------------------
# the cheapest cell against the tracked JAX record
# ---------------------------------------------------------------------------


def test_rwkv6_decode_32k_against_the_tracked_jax_record(tmp_path):
    rec = D.run_cell("rwkv6-1.6b", "decode_32k", "single", force=True, out_dir=str(tmp_path))
    want = json.loads(JAX_RECORD.read_text())
    assert rec["ok"], rec.get("error")
    assert (tmp_path / "single" / "rwkv6-1.6b__decode_32k.json").is_file()
    assert rec["memory"]["argument_size_in_bytes"] == want["memory"]["argument_size_in_bytes"] == 35_318_304
    assert 0 < rec["memory"]["peak_bytes"] < H100_BYTES
    assert rec["memory"]["temp_size_in_bytes"] == rec["memory"]["peak_bytes"] - 35_318_304
    assert rec["mesh_shape"] == want["mesh_shape"] and rec["num_devices"] == want["num_devices"] == 256
    walk = rec["walker"]
    # a decode step of 128 tokens: 2 FLOPs per token and parameter of every
    # product (all but the embedding table, which is gathered), and a little more
    cfg = tconfigs.get_config("rwkv6-1.6b")
    params = tcommon.param_elems(TT.model_skel(cfg)) - cfg.padded_vocab * cfg.d_model
    assert 0.99 * 2 * params * 128 <= walk["flops_global"] <= 1.05 * 2 * params * 128
    assert walk["flops_global"] / 256 <= walk["flops"] < walk["flops_global"]
    assert set(walk["collectives_by_kind"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    status = subprocess.run(["git", "status", "--porcelain", "--", "artifacts"], cwd=REPO, capture_output=True,
                            text=True, check=True).stdout
    assert status == ""


def test_the_default_record_directory_is_not_artifacts():
    assert Path(D.OUT_DIR).resolve() == (REPO / "build" / "dryrun").resolve()


def test_a_failing_cell_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(D, "run_cell", lambda *a, **k: {"ok": False})
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "rwkv6-1.6b", "--shape", "decode_32k", "--mesh", "single"])
    assert e.value.code == 1 and "1 FAILURES" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


# (arch, shape kind) of each flops case: one train, one prefill and one decode cell
FLOP_CASES = [("qwen3-14b", "train"), ("mixtral-8x22b", "prefill"), ("jamba-v0.1-52b", "decode")]
SMALL = {"train": ShapeSpec("train", 8, 16, "train"), "prefill": ShapeSpec("prefill", 16, 16, "prefill"),
         "decode": ShapeSpec("decode", 16, 16, "decode")}


def _unsharded_flops(cfg, shape) -> float:
    """FlopCounterMode over the cell's step on plain CPU tensors."""
    made = []
    make = cases._seeded_make(0, cfg.vocab_size, made)
    if shape.kind == "train":
        state, batch = D.S.train_inputs(cfg, shape)
        args = (tree_like(state, make), tree_like(batch, make))
        opts = TS.TrainOptions(num_microbatches=D.micro_batches_for(cfg, shape), remat="full", pod_sync="gspmd")
        fn = TS.make_train_step(cfg, opts)
    elif shape.kind == "prefill":
        params, batch = D.S.prefill_inputs(cfg, shape)
        args = (tree_like(params, make), tree_like(batch, make))
        fn = lambda p, b: TT.prefill(cfg, p, b, cache_seq=shape.seq_len)
    else:
        params, token, _t, caches = D.S.decode_inputs(cfg, shape)
        args = (tree_like(params, make), make(tuple(token.shape), token.dtype), tree_like(caches, make))
        fn = lambda p, tok, c: TT.decode_step(cfg, p, tok, shape.seq_len - 1, c)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def tree_like(tree, make):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: make(tuple(t.shape), t.dtype), tree)


@pytest.mark.parametrize("arch,kind", FLOP_CASES)
def test_flops_global_equal_the_unsharded_step(arch, kind):
    """With the remat's recompute whole in both: a checkpoint's recompute
    stops at the last tensor the backward saved, and the DTensor program's
    last saved tensor of a block lies one product later (its redistribution
    after the FFN's down projection), so by default it recomputes one
    product a block more than the plain step does."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    shape = SMALL[kind]
    with set_checkpoint_early_stop(False):
        with D._variant_restored(), tmesh.fake_mesh(debug=True) as mesh, FakeTensorMode():
            fn, args = D.build_cell(cfg, shape, mesh, "hoplite_chain")
            rec = D.trace_cell(fn, args)
        with D._variant_restored():
            want = _unsharded_flops(cfg, shape)
    assert want > 0
    assert rec["walker"]["flops_global"] == pytest.approx(want, rel=1e-9)
    assert rec["walker"]["flops"] * 8 >= rec["walker"]["flops_global"]


@pytest.mark.parametrize("kv_heads,split", [(2, True), (1, False)])
def test_a_split_flash_costs_its_share_and_a_replicated_one_more(kv_heads, split):
    """On the (4, 2) mesh: q (8, 4, 16, 16) split on batch over data and on
    heads over model.  With 2 kv heads the heads split (each device 1/8 of
    the FLOPs); with 1 the heads are gathered (the model axis repeats the
    work)."""
    with tmesh.fake_mesh(debug=True) as mesh, FakeTensorMode():
        q = DTensor.from_local(torch.empty(2, 2, 16, 16), mesh, [Shard(0), Shard(1)], run_check=False)
        kv_places = [Shard(0), Shard(1)] if kv_heads == 2 else [Shard(0), Replicate()]
        k_local = (2, kv_heads // 2 if split else kv_heads, 16, 16)
        k = DTensor.from_local(torch.empty(k_local), mesh, kv_places, run_check=False)
        v = DTensor.from_local(torch.empty(k_local), mesh, kv_places, run_check=False)
        with implicit_replication(), op_cost.count() as cost:
            out = tops.flash_attention(q, k, v)
        walk = cost.analyze()["walker"]
    whole = tops.flash_flops((8, 4, 16, 16), (8, kv_heads, 16, 16), True, 0, 0)
    assert walk["flops_global"] == whole
    if split:
        assert out.placements == (Shard(0), Shard(1)) and walk["flops"] * 8 == whole
    else:
        assert out.placements == (Shard(0), Replicate()) and walk["flops"] * 8 == 2 * whole


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [2, 16, 32])
def test_link_bytes_equal_parse_collectives(kind, n):
    dims = [n * 3, 40]
    groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
    line = f"  %c.1 = bf16[{','.join(map(str, dims))}]{{1,0}} {kind}(bf16[8,40] %p), replica_groups={groups}"
    want = jdryrun.parse_collectives(line)
    size = math.prod(dims) * 2
    group = n if kind != "collective-permute" else 2
    assert want["per_kind_count"] == {kind: 1}
    assert op_cost.link_bytes(kind, size, group) == want["per_kind_bytes"][kind]
    assert D.link_bytes is op_cost.link_bytes


@pytest.mark.parametrize("variant,ratio", [("", 2.0), ("bf16partials", 1.0)])
def test_partial_sums_cross_the_mesh_in_their_type(variant, ratio):
    """A bf16 contraction split over the model axis: its all-reduce moves f32
    by default (JAX's f32 partials), bf16 under ``bf16partials``."""
    with D._variant_restored(), tmesh.fake_mesh(debug=True) as mesh, FakeTensorMode():
        D.apply_variant(variant)
        x = DTensor.from_local(torch.empty(2, 8, 32, dtype=torch.bfloat16), mesh, [Shard(0), Shard(2)],
                               run_check=False)
        w = DTensor.from_local(torch.empty(32, 64, dtype=torch.bfloat16), mesh, [Replicate(), Shard(0)],
                               run_check=False)
        with implicit_replication(), op_cost.count() as cost:
            y = tcommon.dense(x, w)
            y = y.redistribute(mesh, [Shard(0), Replicate()])  # a bf16 partial sum is reduced lazily
        coll = cost.analyze()["collectives"]
    assert y.dtype == torch.bfloat16
    bf16_bytes = 2 * 8 * 64 * 2  # the local (2, 8, 64) result in bf16
    assert coll["per_kind_count"] == {"all-reduce": 1}
    assert coll["per_kind_bytes"]["all-reduce"] == op_cost.link_bytes("all-reduce", ratio * bf16_bytes, 2)


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------


def _flash_args(g, causal, window, G):
    q = torch.randn(2, 2 * G, 8, 16, generator=g)
    k, v = torch.randn(2, 2, 8, 16, generator=g), torch.randn(2, 2, 8, 16, generator=g)
    return q, k, v, causal, window, 0


@pytest.mark.parametrize("causal,window,G", [(True, 3, 2), (False, 0, 1)])
def test_flash_custom_ops_pass_opcheck(causal, window, G):
    g = torch.Generator().manual_seed(0)
    args = _flash_args(g, causal, window, G)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_fwd.default, args)
    grad = tuple(t.clone().requires_grad_() for t in args[:3]) + args[3:]
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_fwd_lse.default, grad)


def test_rmsnorm_and_product_custom_ops_pass_opcheck():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    torch.library.opcheck(torch.ops.repro_torch.rmsnorm.default, (x, torch.randn(16, generator=g, requires_grad=True),
                                                                   1e-6))
    w = torch.randn(16, 8, generator=g, requires_grad=True)
    for f32 in (True, False):
        torch.library.opcheck(torch.ops.repro_torch.product.default, (x, w, f32))
    # the weight gradient of ``product``: no gradient of its own
    torch.library.opcheck(torch.ops.repro_torch.product_t.default,
                          (x.detach(), torch.randn(3, 5, 8, generator=g), True))


def test_flash_flops_count_the_visible_pairs():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for Sq, Skv, causal, window, off in [(16, 16, True, 0, 0), (7, 20, True, 5, 13), (16, 24, False, 0, 0)]:
        want = smoke.flash_pairs(torch, Sq, Skv, causal, window, off)
        assert tops.visible_pairs(Sq, Skv, causal, window, off) == want
        assert tops.flash_flops((2, 4, Sq, 32), (2, 2, Skv, 32), causal, window, off) == 4 * 2 * 4 * 32 * want


def _old_flash(q, k, v, causal=True, window=0, q_offset=0):
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q, k, v, causal, window, q_offset)


def _old_rmsnorm(x, w, eps=1e-6):
    from repro_torch.kernels import ref

    return ref.rmsnorm_ref(x, w, eps)


def test_serve_logits_and_kernel_calls_are_unchanged(monkeypatch):
    """Reduced qwen3-14b's prefill and two decode steps: the custom ops give
    the logits the plain functions they wrap give, bit for bit, with the
    calls ``chip_smoke.expected_launches`` predicts and no kernel launched on
    the CPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    params = tcommon.init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu", "float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))

    def run():
        logits, caches = TT.prefill(cfg, params, {"tokens": tokens}, cache_seq=12)
        out = [logits]
        for t in (8, 9):
            logits, caches = TT.decode_step(cfg, params, logits.argmax(-1)[:, None], t, caches)
            out.append(logits)
        return out

    calls = {"flash": 0, "rmsnorm": 0}
    flash, rms = tops.flash_attention, tops.rmsnorm

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    tops.reset_launch_counts()
    monkeypatch.setattr(tops, "flash_attention", counted("flash", flash))
    monkeypatch.setattr(tops, "rmsnorm", counted("rmsnorm", rms))
    new = run()
    assert tops.launch_counts() == dict.fromkeys(tops.launch_counts(), 0)
    want = smoke.expected_launches(cfg, 2)
    assert calls["flash"] == want["flash_attention_cores"] and calls["rmsnorm"] == want["rmsnorm"]
    monkeypatch.setattr(tops, "flash_attention", _old_flash)
    monkeypatch.setattr(tops, "rmsnorm", _old_rmsnorm)
    old = run()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------


def _jax_train_options(variant: str, multi: bool):
    """The TrainOptions the JAX dry run's build_cell makes for qwen3-14b
    train_4k under ``variant`` (its make_train_step captured, nothing traced)."""
    got = {}
    orig = JS.make_train_step
    JS.make_train_step = lambda cfg, mesh, shape, opts: got.setdefault("opts", opts)
    m = tmesh.production_mesh_shape(multi_pod=multi)
    try:
        jdryrun.build_cell(jconfigs.get_config("qwen3-14b"), JSHAPES["train_4k"],
                           JAbstractMesh(m.shape, m.mesh_dim_names), "hoplite_chain", variant)
    except Exception:  # NamedSharding of an AbstractMesh where the JAX dry run wants devices: opts are made by then
        pass
    finally:
        JS.make_train_step = orig
    return got["opts"]


@pytest.mark.parametrize("variant", ["", "rematdots", "micro4", "micro8", "micro32", "podcompress",
                                     "rematdots,micro8,podcompress"])
def test_train_variant_flags_set_what_the_jax_flags_set(variant, monkeypatch):
    seen = {}
    orig = TS.make_train_step
    monkeypatch.setattr(TS, "make_train_step", lambda cfg, opts, pod=None: seen.setdefault("opts", opts) and
                        orig(cfg, opts, pod))
    with D._variant_restored(), tmesh.fake_mesh(multi_pod=True) as mesh, FakeTensorMode():
        D.apply_variant(variant)
        D.build_cell(tconfigs.get_config("qwen3-14b"), SHAPES_BY_NAME["train_4k"], mesh, "hoplite_chain", variant)
    got, want = seen["opts"], _jax_train_options(variant, True)
    for field in ("num_microbatches", "remat", "pod_sync", "pod_compression"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("flag", ["bf16partials", "moedrop"])
def test_model_variant_flags_set_what_the_jax_flags_set(flag):
    jprev, jmode = jcommon.MATMUL_PARTIAL_DTYPE[0], jmoe.MOE_MODE[0]
    try:
        with D._variant_restored():
            assert D.apply_variant(flag) == {flag: True}
            jdryrun.apply_variant(flag)
            if flag == "bf16partials":
                assert tcommon.MATMUL_PARTIAL_DTYPE[0] == torch.bfloat16
                assert jcommon.MATMUL_PARTIAL_DTYPE[0] == jnp.bfloat16
            else:
                assert tmoe.MOE_MODE[0] == jmoe.MOE_MODE[0] == "dropping"
        assert tcommon.MATMUL_PARTIAL_DTYPE[0] == torch.float32 and tmoe.MOE_MODE[0] == "dense"
    finally:
        jcommon.set_matmul_partial_dtype(jprev)
        jmoe.set_moe_mode(jmode)
    with pytest.raises(ValueError):
        D.apply_variant("nosuchflag")


def test_bf16_partial_dense_equals_jax_in_bf16():
    g = np.random.default_rng(0)
    x = g.standard_normal((4, 8, 64)).astype(np.float32)
    w = (g.standard_normal((64, 32)) / 8).astype(np.float32)
    jprev = jcommon.MATMUL_PARTIAL_DTYPE[0]
    try:
        jcommon.set_matmul_partial_dtype(jnp.bfloat16)
        want = np.asarray(jcommon.dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    finally:
        jcommon.set_matmul_partial_dtype(jprev)
    with D._variant_restored():
        D.apply_variant("bf16partials")
        got = tcommon.dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the DTensor program on 8 gloo ranks against one process
# ---------------------------------------------------------------------------


# (name, arch, mesh, kind, planted wrong GQA rule); the planted case runs first
RANK_CASES = [("planted/gemma3-27b/prefill", "gemma3-27b", "single", "prefill", True)]
for _arch in ("qwen3-14b", "mixtral-8x22b", "jamba-v0.1-52b", "whisper-medium", "qwen2-vl-72b"):
    RANK_CASES += [(f"{_arch}/{kind}/{m}", _arch, m, kind, False)
                   for kind, m in (("prefill", "single"), ("decode", "single"), ("train", "multi"))]
RANK_CASES.append(("qwen3-14b/train/single", "qwen3-14b", "single", "train", False))
GENUINE = [c[0] for c in RANK_CASES if not c[4]]


@pytest.fixture(scope="module")
def ranks():
    return TG.run_ranks(cases.dtensor_program_cases, 8, "cpu", RANK_CASES, 0, timeout=600)[0]


def _mismatches(got, want, rtol=RTOL):
    """Paths whose arrays differ by more than rtol of the largest magnitude."""
    bad = []

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            a, b = np.asarray(a), np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-30) if b.size else 1.0
            if a.shape != b.shape or (b.size and float(np.abs(a - b).max()) > rtol * scale):
                bad.append(path)

    walk(got, want, "")
    return bad


@pytest.mark.parametrize("name", GENUINE)
def test_the_dtensor_program_matches_one_process(ranks, name):
    got, want = ranks[name]["sharded"], ranks[name]["plain"]
    assert _mismatches(got, want) == []
    if "loss" in want:
        assert np.isfinite(want["loss"]) and np.isfinite(want["grad_norm"])


def test_a_planted_wrong_gqa_rule_fails_the_check(ranks):
    got, want = ranks["planted/gemma3-27b/prefill"]["sharded"], ranks["planted/gemma3-27b/prefill"]["plain"]
    assert "/logits" in _mismatches(got, want)
