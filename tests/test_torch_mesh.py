"""The partitioner within a pod, on the CPU: the port's launchers over a mesh
of rank processes against the JAX package on its mesh.

Every run is spawned once, in a module-scoped fixture, on the CPU
(``run_ranks(..., "cpu")``: the ``staged`` backend takes the path it takes
on the card, host buffers and gloo).  The JAX side runs once
in a subprocess with 8 host devices (the test process keeps one).

reduced qwen3-14b in f32 (2 layers, d=64, 4 heads, 1 kv head): the JAX
package's initial state (``init_state`` from PRNGKey(0), norm weights
drawn non-zero) crosses to the port as the checkpoint the JAX
``Checkpointer`` writes (the layout both packages share, held byte for byte
in tests/test_torch_checkpoint.py), from which each launcher restarts.
Tolerances: the train step's as tests/test_torch_train.py states them
(loss, gradient norm and lr at 1e-5 relative; each parameter's update within
1e-3 of the JAX update in relative L2 and every element within lr); logits
at 1e-4 as tests/test_torch_serve.py (f32 sums in another order); the
staged backend, restores and pods bit for bit.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AxisType

import torch_rank_cases as cases
from repro.checkpoint.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jget_config, reduced_config as jreduced_config
from repro.train import step as JS
from repro_torch.checkpoint.checkpoint import Checkpointer, named_leaves
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import group as G
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as LS
from repro_torch.launch import train as LT
from repro_torch.serving.engine import ServeOptions
from repro_torch.sharding import placement
from repro_torch.train import step as TS

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-14b"
CFG = reduced_config(get_config(ARCH))
SHAPE = ShapeSpec("mesh", 16, 4, "train")
STEPS = 2
SAMPLES = 64  # elements of each parameter that ``param_samples`` takes (fewer than most leaves hold)
ADAMW = dict(lr=3e-3, warmup_steps=2)
OPTS = TS.TrainOptions(num_microbatches=2, remat="full", pod_sync="gspmd",
                       adamw=dataclasses.replace(TS.TrainOptions().adamw, **ADAMW))
SERVE = dict(batch=4, prompt=8, new_tokens=4, max_seq=32)
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")

JAX_MESH_REF = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro.checkpoint.checkpoint import Checkpointer
from repro.configs import get_config, reduced_config
from repro.configs.base import ShapeSpec
from repro.data import pipeline
from repro.models import transformer as T
from repro.serving.engine import Engine, ServeOptions
from repro.sharding import partitioning
from repro.train import step as TS

out = sys.argv[1]
args = json.loads(sys.argv[2])
cfg = reduced_config(get_config(args["arch"]))
state = TS.init_state(cfg, jax.random.PRNGKey(0))
rng = np.random.RandomState(0)
norms = set(args["norms"])

def fix(path, a):
    a = np.array(a)
    if any(getattr(k, "key", None) in norms for k in path):
        a = (rng.randn(*a.shape) * 0.3).astype(a.dtype)
    return a

state["params"] = jax.tree_util.tree_map_with_path(fix, state["params"])
state = jax.tree_util.tree_map(jnp.asarray, state)
Checkpointer(os.path.join(out, "init")).save(0, state)

# the launcher's step on the debug mesh, with Auto axes (tests/test_torch_train.py)
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
shape = ShapeSpec("mesh", args["seq"], args["batch"], "train")
opts = TS.TrainOptions(num_microbatches=args["micro"], remat="full",
                       adamw=dataclasses.replace(TS.TrainOptions().adamw, **args["adamw"]))
metrics = []
with jax.set_mesh(mesh):
    shardings = TS.state_shardings(cfg, mesh, opts)
    placed = jax.tree_util.tree_map(jax.device_put, state, shardings)
    step = jax.jit(TS.make_train_step(cfg, mesh, shape, opts), in_shardings=(shardings, None),
                   out_shardings=(shardings, None))
    bspecs = partitioning.batch_specs(cfg, mesh, shape, opts.sharding)
    for i in range(args["steps"]):
        placed, m = step(placed, pipeline.device_batch(cfg, shape, i, mesh, bspecs))
        metrics.append({k: float(v) for k, v in m.items()})
    Checkpointer(os.path.join(out, "final")).save(args["steps"], placed)

    # the serve launcher's engine on the same mesh, over the initial parameters
    s = args["serve"]
    params = jax.tree_util.tree_map(jax.device_put, state["params"], shardings["params"])
    T.set_activation_sharding(("data",), "model")
    eng = Engine(cfg, mesh, params, ServeOptions(max_seq=s["max_seq"], batch_size=s["batch"]))
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (s["batch"], s["prompt"])).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    logits, _ = eng.prefill_fn(params, batch)
    gen = eng.generate(batch, s["new_tokens"])
np.save(os.path.join(out, "prefill_logits.npy"), np.asarray(logits)[:, : cfg.vocab_size])
np.save(os.path.join(out, "tokens.npy"), np.asarray(gen))
json.dump(metrics, open(os.path.join(out, "metrics.json"), "w"))
"""


def run_main(main, argv):
    """``main(argv)``'s result and what it printed (module fixtures have no capsys)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


def np32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package on its (4, 2) debug mesh of 8 host devices: the initial
    state (checkpoint step 0), two train steps (metrics, checkpoint of the
    final state), the engine's prefill logits and greedy tokens."""
    d = tmp_path_factory.mktemp("jax_mesh")
    args = dict(arch=ARCH, norms=NORMS, seq=SHAPE.seq_len, batch=SHAPE.global_batch, micro=OPTS.num_microbatches,
                adamw=ADAMW, steps=STEPS, serve=SERVE)
    proc = subprocess.run([sys.executable, "-c", JAX_MESH_REF, str(d), json.dumps(args)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-3000:]}"
    return d


def _copy_init(jax_ref, tmp, name: str) -> str:
    dst = tmp / name
    shutil.copytree(jax_ref / "init", dst)
    return str(dst)


@pytest.fixture(scope="module")
def trains(jax_ref, tmp_path_factory):
    """From the JAX initial state: ``run`` on the (4, 2) mesh (8 ranks), in
    one process, and on (pod 2, data 2, model 2) with hoplite_chain; then
    ``main --devices 8 --multi-pod --pod-sync gspmd`` and one process's
    ``main`` on the same checkpoint, for their printed lines."""
    tmp = tmp_path_factory.mktemp("mesh_trains")
    quiet = lambda _: None
    out = {}
    out["mesh"] = LT.run(CFG, SHAPE, OPTS, "cpu", steps=STEPS, log_every=1, log=quiet,
                         ckpt_dir=_copy_init(jax_ref, tmp, "mesh"), mesh=LT.mesh_for(8), samples=SAMPLES)
    out["one"] = LT.run(CFG, SHAPE, OPTS, "cpu", steps=STEPS, log_every=1, log=quiet,
                        ckpt_dir=_copy_init(jax_ref, tmp, "one"), samples=SAMPLES)
    hoplite = dataclasses.replace(OPTS, pod_sync="hoplite_chain")
    out["hoplite"] = LT.run(CFG, SHAPE, hoplite, "cpu", steps=STEPS, log_every=1, log=quiet,
                            ckpt_dir=_copy_init(jax_ref, tmp, "hoplite"), mesh=LT.mesh_for(8, multi_pod=True),
                            samples=SAMPLES)
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", str(STEPS), "--log-every", "1",
            "--seq-len", str(SHAPE.seq_len), "--global-batch", str(SHAPE.global_batch), "--microbatches", "2"]
    out["gspmd_main"] = run_main(LT.main, argv + ["--devices", "8", "--multi-pod", "--pod-sync", "gspmd",
                                                  "--ckpt-dir", _copy_init(jax_ref, tmp, "gspmd")])
    out["one_main"] = run_main(LT.main, argv + ["--ckpt-dir", _copy_init(jax_ref, tmp, "one_main")])
    out["dirs"] = {name: tmp / name for name in ("mesh", "one", "hoplite", "gspmd")}
    return out


# ---------------------------------------------------------------------------
# the staged backend against gloo
# ---------------------------------------------------------------------------

STAGED_CASES = [f"{kind}/{dt}" for dt in ("float32", "bfloat16")
                for kind in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "dist.all_reduce",
                             "dist.all_gather", "broadcast")] + ["dtensor_uneven/float32"]


@pytest.fixture(scope="module")
def staged():
    return G.run_ranks(cases.staged_collective_cases, 8, "cpu", 0, timeout=300)


@pytest.mark.parametrize("case", STAGED_CASES)
def test_the_staged_backend_gives_gloos_bits(staged, case):
    """Each collective a DTensor program issues, through the staged group
    (host buffers, then gloo), against gloo's own group on the same CPU
    tensors, on every rank: the same bits (blocks of 7 rows, an uneven
    all-to-all, a DTensor of 13 rows over 4 data ranks made whole)."""
    for r, o in enumerate(staged):
        got, want = o["cases"][case]
        assert same_bits(got, want), (r, case)


def test_the_staged_backend_counts_what_it_carries_and_refuses_what_it_lacks(staged):
    for o in staged:
        counts = o["counts"]
        assert {"all_gather", "reduce_scatter", "all_reduce", "all_to_all", "broadcast"} <= set(counts)
        assert all(c["calls"] > 0 and c["bytes"] > 0 and c["seconds"] > 0 for c in counts.values())
        assert "has no gather" in o["refused"]


# ---------------------------------------------------------------------------
# placing real tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def placed():
    return G.run_ranks(cases.placed_devices, 8, "cpu", ARCH, timeout=300)


def test_no_rank_holds_more_than_one_whole_leaf_while_the_state_is_placed(placed):
    """Rank 0 draws one parameter at a time and sends the blocks before the
    next; no other rank ever holds a whole leaf."""
    assert [o["whole_leaves_held"] for o in placed] == [1] + [0] * 7


def test_every_block_lies_on_the_mesh_device_and_another_is_refused(placed):
    for o in placed:
        assert o["mesh_device"] == "cpu" and o["refused"]
        assert o["types"] == {"state": ["cpu"], "batch": ["cpu"], "caches": ["cpu"]}


def test_check_on_mesh_refuses_a_block_from_another_device():
    mesh = M.AbstractMesh((4, 2), M.AXES)
    fake = type("Mesh", (), {"device_type": "cuda", "mesh_dim_names": mesh.mesh_dim_names})()
    with pytest.raises(RuntimeError, match="would be moved"):
        placement.check_on_mesh(torch.zeros(2), fake)
    assert placement.check_on_mesh(torch.zeros(2), type("Mesh", (), {"device_type": "cpu"})()) is not None


def test_the_mesh_takes_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        placement.mesh_device()
    assert placement.mesh_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# launch/train.py --devices 8, against the JAX step on its mesh and one process
# ---------------------------------------------------------------------------


def test_the_mesh_train_step_matches_jax_on_its_mesh(trains, jax_ref):
    """Two steps of ``run`` on the (4, 2) mesh against the JAX launcher's step
    on JAX's (4, 2) debug mesh, from the same state and batches."""
    state, recs = trains["mesh"]
    want = json.loads((jax_ref / "metrics.json").read_text())
    assert [r["step"] for r in recs] == [1, 2]
    for r, w in zip(recs, want):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[key], w[key], rtol=1e-5, err_msg=f"step {r['step']} {key}")
    _, jfinal = Checkpointer(str(jax_ref / "final")).restore(TS.abstract_state(CFG), device="cpu")
    _, init = Checkpointer(str(jax_ref / "init")).restore(TS.abstract_state(CFG), device="cpu")
    assert_updates_agree(state["params"], jfinal["params"], init["params"], "JAX")
    assert int(state["step"]) == STEPS == int(jfinal["step"])


def assert_updates_agree(got, want, init, what: str):
    """Each parameter's update (new - initial) within 1e-3 of the reference's
    in relative L2, and every element within lr: AdamW moves a weight by up
    to lr a step whatever its gradient's size, so an element whose gradient
    is at the f32 noise of sums taken in another order moves by a noisy
    fraction of lr (tests/test_torch_train.py::test_train_step_matches_jax)."""
    lr = ADAMW["lr"]
    for (path, t), (_, j), (_, p0) in zip(named_leaves(got), named_leaves(want), named_leaves(init)):
        t, j, p0 = np32(t), np32(j), np32(p0)
        du, dj = t - p0, j - p0
        assert np.abs(dj).max() > lr, (what, path)  # every leaf moved
        assert np.linalg.norm(du - dj) <= 1e-3 * np.linalg.norm(dj), (what, path)
        np.testing.assert_allclose(t, j, rtol=0, atol=lr, err_msg=f"{what} {path}")


def test_the_mesh_train_step_matches_one_process(trains, jax_ref):
    """The same two steps in one process: 1e-5 relative on the metrics, the
    parameters as ``assert_updates_agree`` holds them."""
    (state, recs), (one_state, one) = trains["mesh"], trains["one"]
    for r, w in zip(recs, one):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[key], w[key], rtol=1e-5, err_msg=f"step {r['step']} {key}")
    _, init = Checkpointer(str(jax_ref / "init")).restore(TS.abstract_state(CFG), device="cpu")
    assert_updates_agree(state["params"], one_state["params"], init["params"], "one process")


@pytest.mark.parametrize("run", ["mesh", "one", "hoplite"])
def test_the_last_record_samples_the_same_elements_of_the_final_parameters(trains, run):
    """``param_samples`` on a mesh (gathered on rank 0) and in one process
    take the same elements: those of the final state, bit for bit."""
    state, recs = trains[run]
    got, want = recs[-1]["param_samples"], LT.param_samples(state["params"], SAMPLES, 0)
    assert got.keys() == want.keys()
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert any(v.size == SAMPLES for v in want.values()) and any(v.size < SAMPLES for v in want.values())


def test_the_smokes_update_check_passes_the_mesh_and_fails_a_state_left_unchanged(trains, jax_ref):
    """chip_smoke.py's ``update_gaps`` on the samples: the mesh's updates
    within 1e-3 of one process's, the initial state's at 1 (no update)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    _, init = Checkpointer(str(jax_ref / "init")).restore(TS.abstract_state(CFG), device="cpu")
    p0 = LT.param_samples(init["params"], SAMPLES, 0)
    one = trains["one"][1][-1]["param_samples"]
    assert max(CS.update_gaps(p0, trains["mesh"][1][-1]["param_samples"], one).values()) <= 1e-3
    assert set(CS.update_gaps(p0, p0, one).values()) == {1.0}


def test_every_rank_records_its_step_and_the_staged_collectives(trains):
    _, recs = trains["mesh"]
    for r in recs:
        assert len(r["ranks"]) == 8 and len(r["digests"]) == 8
        for rank in r["ranks"]:
            assert rank["ms"] > 0 and not any(rank["launches"].values())  # the CPU: no kernel
            assert {"all_gather", "all_reduce"} <= set(rank["collectives"])


def test_the_launcher_resumed_from_the_jax_checkpoint_and_saved_from_the_mesh(trains):
    steps = lambda d: Checkpointer(str(d)).list_steps()
    assert steps(trains["dirs"]["mesh"]) == [0, STEPS]


# ---------------------------------------------------------------------------
# --multi-pod on (pod 2, data 2, model 2)
# ---------------------------------------------------------------------------


def test_hoplite_pods_on_the_mesh_agree_bit_for_bit_and_match_one_process(trains):
    """``hoplite_chain`` between the pods, each pod's state on its (data,
    model) sub-mesh: each rank's blocks equal those of the rank at the same
    (data, model) place in the other pod after every step (``run`` raises
    otherwise), and the metrics equal one process's within 1e-5."""
    (_, recs), (_, one) = trains["hoplite"], trains["one"]
    coords = [np.unravel_index(r, (2, 2, 2)) for r in range(8)]
    for r, w in zip(recs, one):
        by_place = {}
        for c, d in zip(coords, r["digests"]):
            by_place.setdefault((c[1], c[2]), set()).add(d)
        assert all(len(v) == 1 for v in by_place.values()) and len(by_place) == 4
        assert all(rank["sync_ms"] > 0 for rank in r["ranks"])
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[key], w[key], rtol=1e-5, err_msg=f"step {r['step']} {key}")


def test_multi_pod_gspmd_runs_on_the_mesh(trains):
    """``--multi-pod --pod-sync gspmd`` with ``--devices 8``: DTensor reduces
    over the pod axis; the printed losses are one process's."""
    (_, out), (_, plain) = trains["gspmd_main"], trains["one_main"]
    assert "mesh {'pod': 2, 'data': 2, 'model': 2} as 8 rank processes" in out
    assert "[pods] 2 pods' blocks bit for bit the same after every step" in out
    losses = lambda text: [line.split(" tok/s")[0] for line in text.splitlines() if line.startswith("step ")]
    assert len(losses(out)) == STEPS and losses(out) == losses(plain)


def test_devices_must_be_the_debug_meshs_size():
    with pytest.raises(ValueError, match="has 8"):
        LT.mesh_for(4)
    with pytest.raises(NotImplementedError, match="--devices 8"):
        LT.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--multi-pod", "--pod-sync", "gspmd"])


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def restored(trains):
    """The mesh run's final checkpoint (written from (4, 2)) restored onto a
    (2, 2) mesh of 4 ranks and gathered back."""
    d = str(trains["dirs"]["mesh"])
    return G.run_ranks(cases.restore_gathered, 4, "cpu", d, ARCH, (2, 2), timeout=300)[0]


def test_a_checkpoint_from_4x2_restores_onto_2x2_and_one_process_bit_for_bit(trains, restored):
    state, _ = trains["mesh"]
    step, on_2x2 = restored
    step1, one = Checkpointer(str(trains["dirs"]["mesh"])).restore(TS.abstract_state(CFG), device="cpu")
    assert step == step1 == STEPS
    for (path, a), (_, b), (_, c) in zip(named_leaves(state), named_leaves(on_2x2), named_leaves(one)):
        assert same_bits(a, b) and same_bits(a, c), path


def test_the_jax_checkpointer_reads_the_mesh_checkpoint_with_shardings(trains):
    state, _ = trains["mesh"]
    jcfg = jreduced_config(jget_config(ARCH))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    with jax.set_mesh(mesh):
        shardings = JS.state_shardings(jcfg, mesh, JS.TrainOptions())
        step, got = JaxCheckpointer(str(trains["dirs"]["mesh"])).restore(JS.abstract_state(jcfg),
                                                                          shardings=shardings)
    assert step == STEPS
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(got)[0]}
    for path, t in named_leaves(state):
        assert flat[path].tobytes() == t.numpy().tobytes(), path


def test_a_restore_places_each_rank_block_by_the_shardings(trains):
    """In one process, a placement on a one-device fake mesh reads the file's
    block as ``local_slices`` cuts it."""
    with M.fake_mesh(debug=False) as mesh:
        where = placement.shardings(TS.state_specs(CFG, mesh), mesh)
        _, state = Checkpointer(str(trains["dirs"]["mesh"])).restore(TS.abstract_state(CFG), placements=where)
    emb = state["params"]["embed"]
    assert tuple(emb.to_local().shape) == (CFG.padded_vocab, CFG.d_model // 16)


# ---------------------------------------------------------------------------
# launch/serve.py --devices 8 against the JAX engine on its mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serves(jax_ref):
    batch = {"tokens": np.random.RandomState(0).randint(0, CFG.vocab_size, (SERVE["batch"], SERVE["prompt"]))
             .astype(np.int32)}
    opts = ServeOptions(max_seq=SERVE["max_seq"], batch_size=SERVE["batch"])
    init = str(jax_ref / "init")
    mesh = LS.serve(CFG, "cpu", 0, opts, batch, SERVE["new_tokens"], devices=8, ckpt_dir=init, return_logits=True)
    one = LS.serve(CFG, "cpu", 0, opts, batch, SERVE["new_tokens"], ckpt_dir=init, return_logits=True)
    return mesh, one


def test_serve_on_the_mesh_matches_the_jax_engine_on_its_mesh(serves, jax_ref):
    ((toks, logits), _, ranks), _ = serves
    np.testing.assert_allclose(logits[:, 0], np.load(jax_ref / "prefill_logits.npy"), **TOL_LOGITS)
    np.testing.assert_array_equal(toks, np.load(jax_ref / "tokens.npy"))
    assert len(ranks) == 8 and all({"all_gather"} <= set(r["collectives"]) for r in ranks)


def test_serve_on_the_mesh_matches_one_process(serves):
    ((toks, logits), _, _), ((toks1, logits1), _, _) = serves
    np.testing.assert_array_equal(toks, toks1)
    np.testing.assert_allclose(logits, logits1, **TOL_LOGITS)


def test_serve_main_on_the_mesh(capsys):
    LS.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--devices", "8", "--new-tokens", "3",
             "--prompt-len", "8", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "mesh (4, 2) as 8 rank processes: generated (4, 3) tokens" in out


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def test_the_train_lm_example_crashes_restarts_and_learns(tmp_path, capsys):
    from repro_torch.examples import train_lm

    losses = train_lm.main(["--device", "cpu", "--steps", "4", "--crash-at", "2", "--warmup-steps", "1",
                            "--layers", "2", "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "[crash] simulating process loss at step 2" in out and "[restart] resumed at step 2" in out
    assert len(losses) == 4 and losses[-1] < losses[0] and "train_lm OK" in out
    assert abs(losses[0] - np.log(8192)) < 1.0


def test_the_serve_batched_example_matches_the_full_forward(capsys):
    from repro_torch.examples import serve_batched

    out = serve_batched.main(["--device", "cpu", "--requests", "4"])
    printed = capsys.readouterr().out
    assert "prefill/decode == full forward on the first generated token" in printed
    assert "serve_batched OK" in printed and len(out["completed"]) == 4
