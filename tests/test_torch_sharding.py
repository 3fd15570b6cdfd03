"""The port's mesh, partitioning rules and input specs against the JAX
package's, on the CPU, with no device on either side.

The JAX side runs on ``jax.sharding.AbstractMesh``; the port's on
``launch.mesh.fake_mesh``: torch's ``fake`` process-group backend holds a
whole production (256 or 512 ranks) or debug (8 ranks) mesh in this one
process, and under ``FakeTensorMode`` a DTensor on it has its local shape
and no storage.  One default group per process, so each test opens its mesh
and closes it before the next.  Specs are compared normalised to one entry
per tensor dim, each a tuple of mesh axes (JAX leaves trailing ``None``s
implicit and takes ``'pod'`` for ``('pod',)``), and placements are read as
mesh axis -> tensor dim.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

import jax
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.sharding import partitioning as JPT
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import common as tcommon
from repro_torch.models.common import init_params
from repro_torch.models import transformer as TT
from repro_torch.sharding import partitioning as TPT
from repro_torch.train import step as TS

ARCHS = sorted(tconfigs.ARCHS)
# (multi_pod, debug) of each mesh, and its name in the test ids
MESHES = {"production": (False, False), "production_pods": (True, False), "debug": (False, True),
          "debug_pods": (True, True)}
PRODUCTION = ("production", "production_pods")


def jax_mesh(name: str) -> JAbstractMesh:
    multi_pod, debug = MESHES[name]
    m = (tmesh.debug_mesh_shape if debug else tmesh.production_mesh_shape)(multi_pod=multi_pod)
    return JAbstractMesh(m.shape, m.mesh_dim_names)


def fake(name: str, rank: int = 0):
    multi_pod, debug = MESHES[name]
    return tmesh.fake_mesh(multi_pod=multi_pod, debug=debug, rank=rank)


def norm(spec, ndim: int):
    """One entry per tensor dim, each a tuple of mesh axes."""
    entries = list(spec) + [None] * (ndim - len(spec))
    assert len(entries) == ndim, (spec, ndim)
    return tuple(() if e is None else (tuple(e) if isinstance(e, tuple) else (e,)) for e in entries)


def axis_to_dim_of_spec(spec) -> dict:
    return {a: d for d, entry in enumerate(norm(spec, len(spec))) for a in entry}


def axis_to_dim_of_placements(places, mesh) -> dict:
    return {a: p.dim for a, p in zip(mesh.mesh_dim_names, places) if isinstance(p, Shard)}


def paired(t, j, path=""):
    """(path, port leaf, JAX leaf) over two trees of dicts and lists."""
    if isinstance(t, dict):
        assert isinstance(j, dict) and set(t) == set(j), (path, sorted(t), sorted(j))
        for k in t:
            yield from paired(t[k], j[k], f"{path}/{k}")
    elif isinstance(t, list):
        assert isinstance(j, list) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            yield from paired(a, b, f"{path}[{i}]")
    else:
        yield path, t, j


def local_shape(shape, dtype, mesh, places):
    """The local shape of a DTensor of ``shape`` placed ``places`` on this
    rank, made under ``FakeTensorMode`` (no storage)."""
    with FakeTensorMode():
        d = distribute_tensor(torch.empty(shape, dtype=dtype), mesh, list(places))
        return tuple(d.to_local().shape)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group"


# ---------------------------------------------------------------------------
# configs, parameter counts, the meshes
# ---------------------------------------------------------------------------


def test_all_cells_and_shapes_for_match_jax():
    assert sorted(tconfigs.all_cells()) == sorted(jconfigs.all_cells())
    assert len(tconfigs.all_cells()) == 34
    for name in ARCHS:
        got = [s.name for s in tconfigs.shapes_for(tconfigs.get_config(name))]
        assert got == [s.name for s in jconfigs.shapes_for(jconfigs.get_config(name))], name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_elems_bytes_and_abstract_params_match_jax(arch):
    skel, jskel = TT.model_skel(tconfigs.get_config(arch)), JT.model_skel(jconfigs.get_config(arch))
    assert tcommon.param_elems(skel) == jcommon.param_elems(jskel)
    assert tcommon.param_bytes(skel) == jcommon.param_bytes(jskel)
    n = 0
    for path, t, j in paired(tcommon.abstract_params(skel), jcommon.abstract_params(jskel)):
        assert t.device.type == "meta" and tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jcommon.abstract_params(jskel)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fake_mesh_has_the_jax_meshes_shape_and_axes(mesh_name):
    want = jax_mesh(mesh_name)
    with fake(mesh_name) as mesh:
        assert tuple(mesh.shape) == tuple(want.axis_sizes)
        assert tuple(mesh.mesh_dim_names) == tuple(want.axis_names)
        assert dist.get_world_size() == math.prod(mesh.shape) and list(mesh.get_coordinate()) == [0] * mesh.ndim
        multi_pod, debug = MESHES[mesh_name]
        made = (tmesh.make_debug_mesh if debug else tmesh.make_production_mesh)(multi_pod=multi_pod)
        assert tuple(made.shape) == tuple(mesh.shape) and made.mesh_dim_names == mesh.mesh_dim_names


def test_a_real_mesh_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with fake("debug"):
        with pytest.raises(RuntimeError, match="512 ranks; it has 8"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="already initialised"):
            with tmesh.fake_mesh():
                pass


# ---------------------------------------------------------------------------
# placements: parameters and the train state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_match_jax_param_specs(arch, mesh_name):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    jm = jax_mesh(mesh_name)
    want = JPT.param_specs(jcfg, JT.model_skel(jcfg), jm)
    with fake(mesh_name) as mesh:
        specs = TPT.param_specs(cfg, TT.model_skel(cfg), mesh)
        places = TPT.param_placements(cfg, TT.model_skel(cfg), mesh)
        skel = TT.model_skel(cfg)
        n = 0
        for (path, s, j), (_, pl, _), (_, p, _) in zip(paired(specs, want), paired(places, want),
                                                       paired(skel, want)):
            ndim = len(p.shape)
            assert norm(s, ndim) == norm(j, ndim), (path, s, j)
            assert axis_to_dim_of_placements(pl, mesh) == axis_to_dim_of_spec(j), (path, pl, j)
            n += 1
        assert n == len(jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, JP)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_placements_and_local_shapes_match_jax(arch, mesh_name):
    """Every leaf of the train state: its placements are JAX's
    ``state_shardings`` spec, read as mesh axis -> tensor dim; its local
    shape as a DTensor under FakeTensorMode is JAX's ``shard_shape``; and
    this rank's bytes of the whole state are JAX's, summed from the DTensors
    and by ``specs.state_bytes_per_rank`` (PERF.md's table)."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    jm = jax_mesh(mesh_name)
    want = JS.state_shardings(jcfg, jm)
    jstate = JS.abstract_state(jcfg)
    tstate, _ = tspecs.train_inputs(cfg, SHAPES_BY_NAME["train_4k"])
    got_bytes = want_bytes = n = 0
    with fake(mesh_name) as mesh:
        places = TS.state_shardings(cfg, mesh)
        for (path, pl, js), (_, t, j) in zip(paired(places, want), paired(tstate, jstate)):
            assert axis_to_dim_of_placements(pl, mesh) == axis_to_dim_of_spec(js.spec), (path, pl, js.spec)
            local = local_shape(tuple(t.shape), t.dtype, mesh, pl)
            assert local == js.shard_shape(j.shape), (path, local, js.shard_shape(j.shape))
            got_bytes += math.prod(local) * t.element_size()
            want_bytes += math.prod(js.shard_shape(j.shape)) * j.dtype.itemsize
            n += 1
        assert tspecs.state_bytes_per_rank(cfg, mesh) == want_bytes
    assert got_bytes == want_bytes and n == len(jax.tree_util.tree_leaves(jstate))


# ---------------------------------------------------------------------------
# batches, tokens, caches, for every cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_token_and_cache_specs_match_jax_for_every_cell(arch, mesh_name):
    """batch_specs and token_batch_spec for every cell of all_cells(), and
    cache_specs for every decode cell (long_500k included): the specs equal
    JAX's, the placements read as JAX's, and the local shapes of the batch
    and the caches are JAX's shard shapes."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    jm = jax_mesh(mesh_name)
    cells = [s for a, s in tconfigs.all_cells() if a == arch]
    with fake(mesh_name) as mesh:
        for shape_name in cells:
            shape, jshape = SHAPES_BY_NAME[shape_name], JSHAPES[shape_name]
            batch, jbatch = tspecs.train_batch_specs(cfg, shape), jspecs.train_batch_specs(jcfg, jshape)
            got, want = TPT.batch_specs(cfg, mesh, shape), JPT.batch_specs(jcfg, jm, jshape)
            assert set(got) == set(want) == set(batch), (shape_name, sorted(got))
            for key in want:
                ndim = len(jbatch[key].shape)
                assert norm(got[key], ndim) == norm(want[key], ndim), (shape_name, key)
                pl = TPT.placements(got[key], mesh)
                assert axis_to_dim_of_placements(pl, mesh) == axis_to_dim_of_spec(want[key])
                local = local_shape(tuple(batch[key].shape), batch[key].dtype, mesh, pl)
                assert local == NamedSharding(jm, want[key]).shard_shape(jbatch[key].shape), (shape_name, key)
            tok, jtok = TPT.token_batch_spec(mesh, shape.global_batch), JPT.token_batch_spec(jm, jshape.global_batch)
            assert norm(tok, 2) == norm(jtok, 2), shape_name
            if shape.kind != "decode":
                continue
            jcache = JT.cache_skel(jcfg, jshape.global_batch, jshape.seq_len)
            tcache = TT.cache_skel(cfg, shape.global_batch, shape.seq_len)
            specs = TPT.cache_specs(cfg, mesh, shape.global_batch)
            jcspecs = JPT.cache_specs(jcfg, jm, jshape.global_batch)
            for (path, s, js), (_, t, j) in zip(paired(specs, jcspecs), paired(tcache, jcache)):
                assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype), path
                assert norm(s, len(j.shape)) == norm(js, len(j.shape)), (shape_name, path, s, js)
                pl = TPT.placements(s, mesh)
                local = local_shape(tuple(t.shape), t.dtype, mesh, pl)
                assert local == NamedSharding(jm, js).shard_shape(j.shape), (shape_name, path, local)


@pytest.mark.parametrize("cell", sorted(tconfigs.all_cells()), ids="/".join)
def test_input_specs_give_jax_shapes_and_dtypes(cell):
    """prefill_inputs, decode_inputs and train_inputs: every tensor on
    ``meta``, with the shape and dtype of JAX's ShapeDtypeStruct."""
    arch, shape_name = cell
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    shape, jshape = SHAPES_BY_NAME[shape_name], JSHAPES[shape_name]
    for fn in ("prefill_inputs", "decode_inputs", "train_inputs"):
        got, want = getattr(tspecs, fn)(cfg, shape), getattr(jspecs, fn)(jcfg, jshape)
        n = 0
        for path, t, j in paired(list(got), list(want)):
            assert t.device.type == "meta" and tuple(t.shape) == tuple(j.shape), (fn, path)
            assert str(t.dtype).split(".")[-1] == str(j.dtype), (fn, path, t.dtype, j.dtype)
            n += 1
        assert n == len(jax.tree_util.tree_leaves(want)), fn


def test_cache_skel_is_the_engines_cache_tree():
    """cache_skel gives the tree that prefill fills, leaf for leaf."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("whisper-medium"))
    skel = TT.cache_skel(cfg, 2, 16)
    params = init_params(TT.model_skel(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 5), dtype=torch.int64),
             "encoder_frames": torch.zeros((2, cfg.encoder_seq, cfg.d_model))}
    _, caches = TT.prefill(cfg, params, batch, 16)
    for path, s, c in paired(skel, caches):
        assert s.shape == c.shape and s.dtype == c.dtype, path


# ---------------------------------------------------------------------------
# the rules' quirks: replication fallbacks, expert parallelism, tuple order
# ---------------------------------------------------------------------------


def test_replication_fallbacks_match_jax():
    """The same calls on both sides add the same entries to the module's
    list (which only grows): reduced configs at d_model 40 with an unpadded
    vocab of 509, whose dims do not divide the production meshes' axes,
    fall back to replication."""
    jbefore, tbefore = len(JPT.replication_fallbacks()), len(TPT.replication_fallbacks())
    for mesh_name in PRODUCTION:
        jm = jax_mesh(mesh_name)
        with fake(mesh_name) as mesh:
            for arch in ARCHS:
                narrow = dict(d_model=40, vocab_pad_to=1)
                cfg = dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config(arch)), **narrow)
                jcfg = dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config(arch)), **narrow)
                TS.state_shardings(cfg, mesh)
                JS.state_shardings(jcfg, jm)
    got, want = TPT.replication_fallbacks()[tbefore:], JPT.replication_fallbacks()[jbefore:]
    assert got == want and len(got) > 0


def test_full_configs_fall_back_nowhere():
    before = len(TPT.replication_fallbacks())
    for mesh_name in MESHES:
        with fake(mesh_name) as mesh:
            for arch in ARCHS:
                TS.state_shardings(tconfigs.get_config(arch), mesh)
    assert TPT.replication_fallbacks()[before:] == []


@pytest.mark.parametrize("mesh_name", PRODUCTION)
def test_expert_parallel_and_the_dense_ffn_override_match_jax(mesh_name):
    """Under expert parallelism a dense FFN still takes the model axis on
    "mlp"; jamba mixes both kinds of FFN."""
    jm = jax_mesh(mesh_name)
    with fake(mesh_name) as mesh:
        for arch in ARCHS:
            cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
            opts, jopts = TPT.ShardingOptions(), JPT.ShardingOptions()
            assert TPT.expert_parallel(cfg, mesh, opts) == JPT.expert_parallel(jcfg, jm, jopts), arch
            assert TPT.logical_rules(cfg, mesh, opts) == JPT.logical_rules(jcfg, jm, jopts), arch
        assert TPT.expert_parallel(tconfigs.get_config("jamba-v0.1-52b"), mesh, TPT.ShardingOptions())


OPTION_VARIANTS = [TPT.ShardingOptions(), TPT.ShardingOptions(shard_embed_over_pod=True),
                   TPT.ShardingOptions(sequence_parallel=True),
                   TPT.ShardingOptions(shard_embed_over_pod=True, sequence_parallel=True)]


@pytest.mark.parametrize("variant", range(len(OPTION_VARIANTS)))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_no_config_reaches_a_tuple_out_of_mesh_order(mesh_name, variant):
    """Every spec of every config, cell and ShardingOptions knob converts to
    placements (a tuple out of the mesh's order would raise), and the specs
    under the knobs equal JAX's."""
    opts = OPTION_VARIANTS[variant]
    jopts = JPT.ShardingOptions(**dataclasses.asdict(opts))
    jm = jax_mesh(mesh_name)
    with fake(mesh_name) as mesh:
        for arch in ARCHS:
            cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
            specs = TPT.param_specs(cfg, TT.model_skel(cfg), mesh, opts)
            want = JPT.param_specs(jcfg, JT.model_skel(jcfg), jm, jopts)
            trees = [(specs, want)]
            for shape_name in (s for a, s in tconfigs.all_cells() if a == arch):
                shape = SHAPES_BY_NAME[shape_name]
                trees.append((TPT.batch_specs(cfg, mesh, shape, opts), JPT.batch_specs(jcfg, jm, shape, jopts)))
                trees.append((TPT.cache_specs(cfg, mesh, shape.global_batch, opts),
                              JPT.cache_specs(jcfg, jm, shape.global_batch, jopts)))
                trees.append(([TPT.token_batch_spec(mesh, shape.global_batch, opts)],
                              [JPT.token_batch_spec(jm, shape.global_batch, jopts)]))
            for got, exp in trees:
                for path, s, j in paired(got, exp):
                    TPT.placements(s, mesh)
                    n = max(len(s), len(j))
                    assert norm(s, n) == norm(j, n), (arch, path, s, j)


def test_a_tuple_out_of_mesh_order_raises():
    m = tmesh.production_mesh_shape(multi_pod=True)
    assert TPT.placements(TPT.P(("pod", "data"), "model"), m) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(NotImplementedError, match="_StridedShard"):
        TPT.placements(TPT.P(("data", "pod")), m)
    with pytest.raises(ValueError, match="not on the mesh"):
        TPT.placements(TPT.P("pod"), tmesh.production_mesh_shape())
    with pytest.raises(ValueError, match="two tensor dims"):
        TPT.placements(TPT.P("data", "data"), m)


@pytest.mark.parametrize("rank", [0, 37, 300, 511])
def test_local_slices_are_dtensors_blocks(rank):
    """``local_slices`` (which gives a pod its share of a batch) is the block
    DTensor places on the device at the mesh coordinate, checked on ranks
    other than 0 of the fake 512-rank mesh."""
    with fake("production_pods", rank=rank) as mesh:
        coord = mesh.get_coordinate()
        for spec, shape in ((TPT.P(("pod", "data"), None), (256, 4096)), (TPT.P(None, ("pod", "data"), "model"), (3, 64, 4096)),
                            (TPT.P(None, None, ("pod", "data", "model"), None, None), (40, 1, 524288, 8, 128))):
            pl = TPT.placements(spec, mesh)
            sl = TPT.local_slices(shape, pl, mesh, coord)
            lshape, offset = compute_local_shape_and_global_offset(shape, mesh, list(pl))
            assert tuple(s.stop - s.start for s in sl) == tuple(lshape)
            assert tuple(s.start for s in sl) == tuple(offset)


# ---------------------------------------------------------------------------
# the activation-sharding hints
# ---------------------------------------------------------------------------


@pytest.fixture
def policy():
    saved = dict(TT.ACTIVATION_SHARDING)
    yield
    TT.ACTIVATION_SHARDING.update(saved)


def test_constrain_returns_a_plain_tensor_unchanged(policy):
    x = torch.randn(2, 3, 4)
    assert TT._constrain(x, ("batch", None, "tp")) is x
    TT.set_activation_sharding(("pod", "data"), "model")
    assert TT._constrain(x, ("batch", None, "tp")) is x


@pytest.mark.parametrize("mesh_name", ["debug", "debug_pods"])
def test_constrain_redistributes_a_dtensor_to_the_policys_placements(policy, mesh_name):
    batch_axes = ("pod", "data") if "pods" in mesh_name else ("data",)
    with fake(mesh_name) as mesh:
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 16, 32), mesh, [Replicate()] * mesh.ndim)
            assert TT._constrain(x, ("batch", None, "tp")) is x  # no policy set
            TT.set_activation_sharding(batch_axes, "model")
            y = TT._constrain(x, ("batch", None, "tp"))
            want = JP(batch_axes, None, "model")
            assert isinstance(y, DTensor)
            assert axis_to_dim_of_placements(y.placements, mesh) == axis_to_dim_of_spec(want)
            assert tuple(y.to_local().shape) == NamedSharding(jax_mesh(mesh_name), want).shard_shape((8, 16, 32))
            w = distribute_tensor(torch.empty(32, 64), mesh, [Replicate()] * mesh.ndim)
            assert TT._constrain(w, (None, "tp")).placements[-1] == Shard(1)


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-medium", "jamba-v0.1-52b"])
def test_the_policy_changes_no_number_and_no_launch_of_a_plain_model(policy, arch):
    """forward, train_loss, prefill and decode of a reduced model on plain
    tensors: the same logits, loss, caches and kernel launches with the
    policy set and unset, and every call site passes its tensor through."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    params = init_params(TT.model_skel(cfg), torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))}
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.from_numpy(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model),
                                                                       dtype=np.float32))

    def outputs():
        tops.reset_launch_counts()
        logits, _ = TT.forward(cfg, params, batch)
        loss = TT.train_loss(cfg, params, batch)
        last, caches = TT.prefill(cfg, params, batch, 16)
        step, _ = TT.decode_step(cfg, params, batch["tokens"][:, :1], 12, caches)
        return [logits, loss, last, step], tops.launch_counts()

    unset, unset_counts = outputs()
    calls = []
    constrain = TT._constrain

    def counted(x, dims):
        calls.append(dims)
        return constrain(x, dims)

    TT.set_activation_sharding(("data",), "model")
    TT._constrain = counted
    try:
        got, got_counts = outputs()
    finally:
        TT._constrain = constrain
    assert all(torch.equal(a, b) for a, b in zip(got, unset)) and got_counts == unset_counts
    assert ("batch", None, "tp") in calls and (None, "tp") in calls and ("batch", None, None) in calls
