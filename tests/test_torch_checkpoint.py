"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), and restart through the port's launcher,
on the CPU.

The state is reduced qwen3-14b's train state, with f32 and with bf16
parameters: built by the JAX package's ``init_state`` under a (1, 1) mesh of
Auto axes (as tests/test_torch_train.py builds it), then every leaf given
random values from a seed (parameters, moments, counts), so that no leaf is
all zeros.  Each package writes it and reads the other's; files and leaves
must agree bit for bit: there is no tolerance here.
"""

import dataclasses
import filecmp
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs as jconfigs
from repro.checkpoint.checkpoint import Checkpointer as JaxCheckpointer
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import train as ttrain
from repro_torch.train import step as TS
from repro_torch.tree import leaves, tree_map

STEP = 7
DTYPES = ["float32", "bfloat16"]


def configs(dtype: str):
    """Reduced qwen3-14b in both packages, with ``dtype`` activations and parameters."""
    over = dict(dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")), **over),
            dataclasses.replace(jconfigs.reduced_config(jconfigs.get_config("qwen3-14b")), **over))


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers of its width (other types as they are)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def assert_same_bits(got, want):
    """Two trees of tensors with the same leaves in the same order, bit for bit."""
    got, want = list(leaves(got)), list(leaves(want))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(bits(a.cpu()), bits(b.cpu())), i


@pytest.fixture(scope="module", params=DTYPES)
def case(request):
    """(dtype, port config, JAX config, the JAX state as jax arrays)."""
    cfg, jcfg = configs(request.param)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    rng = np.random.RandomState(0)

    def fill(a):
        if jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(rng.randn(*a.shape).astype(np.float32), a.dtype)
        return jnp.asarray(rng.randint(1, 1000, size=a.shape), a.dtype)

    with jax.set_mesh(mesh):
        state = jax.tree_util.tree_map(fill, JS.init_state(jcfg, jax.random.PRNGKey(0), mesh))
    return request.param, cfg, jcfg, state


def port_state(case):
    """A fresh port state of ``case``'s numbers (the train step updates states in place)."""
    _, cfg, _, jstate = case
    return convert.state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), cfg, device="cpu")


# ---------------------------------------------------------------------------
# the layout, and each package reading the other's
# ---------------------------------------------------------------------------


def test_layout_matches_the_jax_package_byte_for_byte(case, tmp_path):
    """Same directory, same file names, same bytes: every leaf's .npy (a bf16
    leaf under the header '<V2') and MANIFEST.json (JAX's sorted leaf order,
    indent 1)."""
    dtype, _, _, jstate = case
    JaxCheckpointer(str(tmp_path / "jax")).save(STEP, jstate)
    Checkpointer(str(tmp_path / "port")).save(STEP, port_state(case))
    assert os.listdir(tmp_path / "jax") == os.listdir(tmp_path / "port") == [f"step_{STEP:08d}"]
    a, b = tmp_path / "jax" / f"step_{STEP:08d}", tmp_path / "port" / f"step_{STEP:08d}"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) == 1 + 2 + 3 * 14 and "MANIFEST.json" in names
    same, differ, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not differ and not errors and len(same) == len(names)
    manifest = json.loads((b / "MANIFEST.json").read_text())
    assert manifest["step"] == STEP
    assert list(manifest["leaves"]) == jax_paths(jstate)
    assert manifest["leaves"]["opt/count"] == {"file": "opt__count.npy", "shape": [], "dtype": "int32"}
    assert manifest["leaves"]["params/embed"]["dtype"] == dtype
    if dtype == "bfloat16":
        assert b"'descr': '<V2'" in (b / "params__embed.npy").read_bytes()[:128]


def jax_paths(tree):
    """The JAX package's leaf names, in its order (repro/checkpoint/checkpoint.py:38-46)."""
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_named_leaves_follow_jax_flatten_order(case):
    _, _, _, jstate = case
    want = jax_paths(jstate)
    assert [n for n, _ in CK.named_leaves(port_state(case))] == want
    assert [n for n, _ in CK.named_leaves(jstate)] == want
    # the port's own walk (tree.leaves) keeps insertion order: params come first
    assert want[0] == "opt/count" and want[-1] == "step"


def test_the_port_restores_a_jax_checkpoint_bit_for_bit(case, tmp_path):
    """Into ``TS.abstract_state`` on ``meta``: equal to ``convert.state_from_jax``
    bit for bit, bf16 included, in the port's own leaf order."""
    _, cfg, _, jstate = case
    JaxCheckpointer(str(tmp_path)).save(STEP, jstate)
    step, got = Checkpointer(str(tmp_path)).restore(TS.abstract_state(cfg), device="cpu")
    assert step == STEP
    assert_same_bits(got, port_state(case))
    assert all(t.device.type == "cpu" for t in leaves(got))


def test_jax_restores_a_port_checkpoint(case, tmp_path):
    """The JAX package's ``restore(tree_like)`` gives the JAX state's bytes;
    a bf16 leaf comes back as numpy's void type 'V2' with its bits (the JAX
    package's own behaviour on its own checkpoints)."""
    dtype, _, jcfg, jstate = case
    Checkpointer(str(tmp_path)).save(STEP, port_state(case))
    step, got = JaxCheckpointer(str(tmp_path)).restore(JS.abstract_state(jcfg))
    assert step == STEP
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)
    assert len(got_leaves) == len(want_leaves) == 2 + 3 * 14
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
        assert g.dtype == (np.dtype("V2") if w.dtype.name == "bfloat16" else w.dtype)
    assert any(g.dtype == np.dtype("V2") for g in got_leaves) == (dtype == "bfloat16")


def test_the_jax_launchers_restore_takes_f32_and_refuses_bf16(case, tmp_path):
    """The JAX launcher restores with shardings (repro/launch/train.py:77),
    which puts the arrays on devices: a port-written f32 state resumes there
    bit for bit, a bf16 one cannot (its 'V2' arrays are refused), whichever
    package wrote it.  The port reads the manifest's type."""
    dtype, cfg, jcfg, jstate = case
    Checkpointer(str(tmp_path)).save(STEP, port_state(case))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    with jax.set_mesh(mesh):
        shardings = JS.state_shardings(jcfg, mesh, JS.TrainOptions())
        restore = lambda: JaxCheckpointer(str(tmp_path)).restore(JS.abstract_state(jcfg), shardings=shardings)
        if dtype == "bfloat16":
            with pytest.raises(TypeError, match="V2"):
                restore()
        else:
            got = jax.tree_util.tree_leaves(restore()[1])
            for g, w in zip(got, jax.tree_util.tree_leaves(jstate)):
                assert g.dtype == w.dtype and np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert Checkpointer(str(tmp_path)).restore(TS.abstract_state(cfg), device="cpu")[0] == STEP


# ---------------------------------------------------------------------------
# atomic, async, keep, and the checks on restore
# ---------------------------------------------------------------------------


class FailOnLeaf:
    """``_save_leaf`` that raises on its ``k``-th call (1-based)."""

    def __init__(self, k: int):
        self.k, self.calls, self.save = k, 0, CK._save_leaf

    def __call__(self, *args):
        self.calls += 1
        if self.calls == self.k:
            raise OSError(f"disk full on leaf {self.k}")
        return self.save(*args)


@pytest.mark.parametrize("is_async", [False, True], ids=["save", "save_async"])
@pytest.mark.parametrize("k", [1, 5, 44])
def test_a_failed_write_leaves_the_latest_step_intact(case, tmp_path, monkeypatch, is_async, k):
    """A write that fails on its k-th leaf (of 44) raises from ``save`` or
    from ``wait``, leaves no ``step_`` directory and no temporary for the
    failed step, and the step before it restores as it was written."""
    _, cfg, _, _ = case
    first, second = port_state(case), tree_map(lambda t: t + 1, port_state(case))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, first)
    monkeypatch.setattr(CK, "_save_leaf", FailOnLeaf(k))
    with pytest.raises(OSError, match=f"leaf {k}"):
        if is_async:
            ck.save_async(2, second)
            ck.wait()
        else:
            ck.save(2, second)
    assert ck.list_steps() == [1] and os.listdir(tmp_path) == ["step_00000001"]
    assert_same_bits(ck.restore(TS.abstract_state(cfg), device="cpu")[1], first)
    monkeypatch.undo()
    ck.wait()  # the error was raised once
    ck.save(2, second)
    assert ck.latest_step() == 2


def test_keep_the_newest_steps_and_ignore_temporaries(tmp_path):
    cfg, _ = configs("float32")
    state = TS.init_state(cfg, 0, "cpu")
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (3, 1, 4, 2):
        ck.save(s, state)
    assert ck.list_steps() == [3, 4]
    os.makedirs(tmp_path / ".tmp-step_00000009-deadbeef")  # a write that died
    (tmp_path / ".tmp-step_00000009-deadbeef" / "params__embed.npy").write_bytes(b"torn")
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4
    assert Checkpointer(str(tmp_path)).restore(TS.abstract_state(cfg), device="cpu")[0] == 4
    ck.save(4, state)  # the same step again replaces it
    assert sorted(os.listdir(tmp_path)) == [".tmp-step_00000009-deadbeef", "step_00000003", "step_00000004"]


def test_a_write_drops_each_array_once_its_file_is_written(tmp_path, monkeypatch):
    """The snapshot's arrays go as their files are written: an async write
    holds at most the leaves still to write."""
    cfg, _ = configs("float32")
    ck = Checkpointer(str(tmp_path))
    host, _ = ck._snapshot(1, TS.init_state(cfg, 0, "cpu"), is_async=False)
    n, left = len(host), []
    save = CK._save_leaf
    monkeypatch.setattr(CK, "_save_leaf", lambda *args: (left.append(len(host)), save(*args)))
    ck._write(1, host)
    assert host == [] and left == list(range(n - 1, -1, -1))


def test_restore_checks_every_leaf_against_the_tree(tmp_path, monkeypatch):
    cfg, _ = configs("bfloat16")
    state = TS.init_state(cfg, 0, "cpu")
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore(TS.abstract_state(cfg), device="cpu")
    ck.save(1, state)
    like = TS.abstract_state(cfg)
    like["params"]["embed"] = torch.empty(like["params"]["embed"].shape[::-1], device="meta",
                                          dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params/embed.*shape"):
        ck.restore(like, device="cpu")
    with pytest.raises(ValueError, match="opt/count.*dtype"):
        ck.restore(dict(TS.abstract_state(cfg), opt=dict(TS.abstract_state(cfg)["opt"],
                                                           count=torch.empty((), dtype=torch.int64))), device="cpu")
    f32 = TS.abstract_state(configs("float32")[0])  # the same names and shapes, f32 parameters
    with pytest.raises(ValueError, match="bfloat16"):
        ck.restore(f32, device="cpu")
    with pytest.raises(ValueError, match="no such leaf"):
        ck.restore(dict(TS.abstract_state(cfg), extra=torch.empty(())), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore(TS.abstract_state(cfg))  # the card is the default


def test_restore_checks_the_files_against_the_manifest(tmp_path):
    cfg, _ = configs("float32")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, TS.init_state(cfg, 0, "cpu"))
    leaf = tmp_path / "step_00000001" / "opt__count.npy"
    np.save(leaf, np.zeros((), np.int64))
    with pytest.raises(ValueError, match="opt/count.*int64"):
        ck.restore(TS.abstract_state(cfg), device="cpu")


def test_save_async_copies_the_state_before_it_returns(tmp_path, monkeypatch):
    """The train step updates parameters and moments in place right after
    ``save_async`` returns: the checkpoint holds the state as it was."""
    cfg, _ = configs("bfloat16")
    state = TS.init_state(cfg, 0, "cpu")
    want = tree_map(torch.clone, state)
    updated = threading.Event()
    save = CK._save_leaf

    def after_the_update(*args):
        assert updated.wait(timeout=60)
        return save(*args)

    monkeypatch.setattr(CK, "_save_leaf", after_the_update)
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, state)
    assert ck.in_flight()
    for t in leaves(state):
        t.add_(1)
    updated.set()
    ck.wait()
    assert ck._thread is None and not ck.in_flight()
    assert_same_bits(ck.restore(TS.abstract_state(cfg), device="cpu")[1], want)
    rec = ck.history[0]
    assert rec["async"] and rec["step"] == 1 and rec["write_s"] > 0 and rec["snapshot_s"] > 0
    assert rec["bytes"] == sum(t.numel() * t.element_size() for t in leaves(want))
    assert ck.history[1]["restore_s"] > 0 and ck.history[1]["bytes"] == rec["bytes"]


# ---------------------------------------------------------------------------
# restart through the launcher
# ---------------------------------------------------------------------------

SHAPE = ShapeSpec("t", 16, 4, "train")
OPTIONS = TS.TrainOptions(num_microbatches=2)


def test_restart_resumes_bit_for_bit(tmp_path):
    """4 steps with a checkpoint every 2, then a new run to 6 steps from the
    same directory: it resumes at step 4, and its losses, gradient norms and
    final checkpoint equal an uninterrupted 6-step run's bit for bit."""
    cfg, _ = configs("float32")
    run = lambda steps, d, logs, every=2: ttrain.run(cfg, SHAPE, OPTIONS, "cpu", steps=steps, seed=0, log_every=1,
                                                      log=logs.append, ckpt_dir=str(d), ckpt_every=every)[1]
    logs_a, logs_b = [], []
    whole = run(6, tmp_path / "whole", logs_a, every=100)
    first = run(4, tmp_path / "cut", logs_b)
    assert [r["step"] for r in first] == [1, 2, 3, 4]
    assert Checkpointer(str(tmp_path / "cut")).list_steps() == [2, 4]
    resumed = run(6, tmp_path / "cut", logs_b)
    assert "[restart] resumed from checkpoint step 4" in logs_b
    assert not any(m.startswith("[restart]") for m in logs_a)
    assert logs_b.count("[ckpt] final checkpoint at step 4") == logs_b.count("[ckpt] final checkpoint at step 6") == 1
    assert [r["step"] for r in resumed] == [5, 6]
    for key in ("loss", "grad_norm", "lr"):
        assert [r[key] for r in resumed] == [r[key] for r in whole[4:]], key
    a, b = tmp_path / "whole" / "step_00000006", tmp_path / "cut" / "step_00000006"
    names = sorted(os.listdir(a))
    assert filecmp.cmpfiles(a, b, names, shallow=False)[0] == names
    # tokens/s counts the steps this run took, not the step index
    tokens = SHAPE.global_batch * SHAPE.seq_len
    assert resumed[0]["tok_s"] <= tokens / (resumed[0]["ms"] / 1e3)
