"""The port's object store and reduce ops against the JAX package's.

``repro_torch.core.store`` keeps each object as a ``torch.uint8`` buffer
on the store's device (here the CPU); ``repro.core.store`` keeps a numpy
uint8 array.  The same bytes go in, the same bytes come out, and eviction,
pinning and watermarks follow the same steps.  ``api.SUM`` folds f32, bf16
and f16 through ``ops.chunk_reduce`` (its plain version on the CPU) and
every other dtype through ``torch.add``; both are held bit for bit to
numpy's add, which is what the JAX data plane computes, and the f16 fold to
the JAX package's ``chunk_reduce`` kernel (Pallas, interpret mode).
"""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as JA
from repro.core import store as JST
from repro.kernels import ops as jops
from repro_torch.core import api as TA
from repro_torch.core import store as TST
from repro_torch.core.local import LocalCluster
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")
DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64"]


def np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


def t2n(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy with the same bits (bf16 as ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def draw(name, n, seed=0, integers=False):
    rng = np.random.RandomState(seed)
    if name == "bool":
        return rng.rand(n) < 0.5
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return rng.randint(max(info.min, -1000), min(info.max, 1000), size=n).astype(name)
    x = rng.randint(-64, 64, size=n) if integers else rng.randn(n) * 10
    return x.astype(np_dtype(name))


# ---------------------------------------------------------------------------
# dtypes in and out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
def test_as_tensor_keeps_every_bit(name):
    a = draw(name, 1001, seed=1).reshape(7, 11, 13)
    t = TA.as_tensor(a, CPU)
    assert t.dtype == TA.DTYPES[name] and tuple(t.shape) == a.shape and t.is_contiguous()
    assert t2n(t).tobytes() == a.tobytes()
    assert TA.as_tensor(t, CPU).data_ptr() == t.data_ptr()  # a tensor on the device is kept


@pytest.mark.parametrize("name", ["uint16", "uint32", "uint64"])
def test_unsigned_wide_integers_are_refused(name):
    a = np.arange(10, dtype=name)
    with pytest.raises(TypeError, match="no CUDA add"):
        TA.as_tensor(torch.from_numpy(a), CPU)
    with pytest.raises(TypeError, match=f"not numpy {name}"):
        TA.as_tensor(a, CPU)
    c = LocalCluster(2, device="cpu")
    with pytest.raises(TypeError):
        c.put(0, "u", a)
    assert "u" not in c.meta


# ---------------------------------------------------------------------------
# the reduce ops: numpy's results, bit for bit, by the stated route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("op", ["SUM", "MIN", "MAX"])
def test_reduce_ops_match_numpy_bit_for_bit(name, op):
    a, b = draw(name, 4099, seed=2), draw(name, 4099, seed=3)
    if name == "bool" and op == "SUM":
        want = np.logical_or(a, b)  # numpy's bool add
    else:
        want = getattr(JA, op)(a, b)
    top = getattr(TA, op)
    top.reset_counts()
    ta, tb = TA.as_tensor(a, CPU), TA.as_tensor(b, CPU)
    got = top(ta, tb)
    assert got.dtype == ta.dtype
    assert t2n(got).tobytes() == np.asarray(want, dtype=a.dtype).tobytes()
    out = torch.empty_like(ta)
    top.into(ta, tb, out)  # the form a fold window takes
    assert torch.equal(out, got)
    top.into(ta, tb, ta)  # in place, out = a
    assert torch.equal(ta, got)
    route = {"SUM": "chunk_reduce" if TA.DTYPES[name] in TA.KERNEL_DTYPES else "add",
             "MIN": "minimum", "MAX": "maximum"}[op]
    assert top.counts == {route: 3}


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32"])
@pytest.mark.parametrize("n", [17, 4099, 100_003])
def test_sum_of_kernel_dtypes_is_the_jax_chunk_reduce_kernel(name, n):
    """The JAX package's ``chunk_reduce`` (Pallas, interpret mode) and the
    port's SUM (the kernel's plain version on the CPU) give the same bits,
    at windows that start off any 16-byte boundary."""
    a, b = draw(name, n + 5, seed=4), draw(name, n + 5, seed=5)
    want = np.asarray(jops.chunk_reduce(jnp.asarray(a[3:]), jnp.asarray(b[3:])))
    ta, tb = TA.as_tensor(a, CPU), TA.as_tensor(b, CPU)
    got = TA.SUM(ta[3:], tb[3:])
    assert t2n(got).tobytes() == want.tobytes()
    assert t2n(got).tobytes() == (a[3:] + b[3:]).tobytes()  # numpy: f32 math, rounded once


def test_sum_kernel_launch_count_is_zero_on_the_cpu():
    tops.reset_launch_counts()
    TA.SUM(torch.ones(8, dtype=torch.float16), torch.ones(8, dtype=torch.float16))
    assert tops.launch_counts()["chunk_reduce"] == 0


# ---------------------------------------------------------------------------
# ChunkedBuffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("shape", [(0,), (), (5,), (3, 40, 7)])
def test_chunked_buffer_round_trip_matches_jax(name, shape):
    a = draw(name, int(np.prod(shape)), seed=6).reshape(shape)
    jb = JST.ChunkedBuffer.from_array(a, chunk_size=64)
    tb = TST.ChunkedBuffer.from_array(TA.as_tensor(a, CPU), chunk_size=64)
    assert (tb.size, tb.bytes_present, tb.complete, tb.num_chunks(), tb.available_chunks()) == (
        jb.size, jb.bytes_present, jb.complete, jb.num_chunks(), jb.available_chunks())
    assert tb.to_bytes() == jb.to_bytes() == a.tobytes()
    got = tb.to_array(TA.DTYPES[name], shape)
    assert tuple(got.shape) == shape and t2n(got).tobytes() == a.tobytes()
    assert got.data_ptr() == tb.data.data_ptr() or tb.size == 0  # a view, as numpy's
    for k in range(tb.num_chunks() if tb.size else 0):
        assert t2n(tb.read_chunk(k)).tobytes() == jb.read_chunk(k).tobytes()
    assert t2n(tb.view(1, 9)).tobytes() == jb.view(1, 9).tobytes()


def test_chunked_buffer_watermarks_match_jax():
    raw = np.random.RandomState(7).randint(0, 256, size=1000).astype(np.uint8)
    jb = JST.ChunkedBuffer(1000, chunk_size=128)
    tb = TST.ChunkedBuffer(1000, chunk_size=128, device=CPU)
    assert tb.data.dtype == torch.uint8 and tb.device == CPU and int(tb.data.sum()) == 0
    for lo, hi in ((0, 100), (100, 300), (300, 257 + 300), (557, 1000)):
        jb.write_chunk(lo, raw[lo:hi])
        tb.write_chunk(lo, torch.from_numpy(raw[lo:hi]))
        assert (tb.bytes_present, tb.available_chunks(), tb.complete) == (
            jb.bytes_present, jb.available_chunks(), jb.complete)
    assert tb.to_bytes() == jb.to_bytes()
    # advance over bytes written in place above the watermark
    b2 = TST.ChunkedBuffer(1000, chunk_size=128, device=CPU)
    b2.data[:640].copy_(torch.from_numpy(raw[:640]))
    assert b2.bytes_present == 0
    b2.write_chunk(0, None, end=640)
    assert b2.bytes_present == 640 and t2n(b2.view(0, 640)).tobytes() == raw[:640].tobytes()
    b2.write_chunk(0, None, end=320)  # the watermark never goes back
    assert b2.bytes_present == 640


def test_chunked_buffer_waits_and_fails_like_jax():
    for mod, kw in ((JST, {}), (TST, {"device": CPU})):
        b = mod.ChunkedBuffer(256, chunk_size=64, stats=mod.DataPlaneStats(), **kw)
        assert b.wait_for_bytes(64, timeout=0.05) == 0  # timed out
        t = threading.Timer(0.05, lambda: b.write_chunk(0, (torch.zeros(128, dtype=torch.uint8)
                                                            if mod is TST else np.zeros(128, np.uint8))))
        t.start()
        assert b.wait_for_bytes(64, timeout=10.0) == 128
        t.join()
        threading.Timer(0.05, b.fail).start()
        t0 = time.time()
        assert b.wait_for_bytes(256, timeout=10.0) == 128 and b.failed
        assert time.time() - t0 < 5.0
        assert b.stats.wakeups >= 2 and b.stats.notifies >= 1


# ---------------------------------------------------------------------------
# NodeStore: eviction, pinning and capacity, step for step with the JAX store
# ---------------------------------------------------------------------------


def _store_script(mod, kw, arr):
    """tests/test_store_eviction.py's scenarios in one script; the state
    after each step."""
    s = mod.NodeStore(0, capacity_bytes=200, **kw)
    trace = []

    def unpinned(oid, size):
        buf = s.create(oid, size, pinned=False, chunk_size=16)
        buf.write_chunk(0, arr(np.zeros(size, np.uint8)))

    def state(tag):
        trace.append((tag, sorted(s.objects), sorted(s.pinned), list(s._lru), s.used_bytes,
                      s.recompute_used_bytes()))

    s.put_array("a", arr(np.zeros(60, np.uint8))); state("put a")
    s.put_array("a", arr(np.zeros(60, np.uint8))); state("re-put a")
    unpinned("b", 50); state("b")
    inflight = s.create("in", 40, pinned=False, chunk_size=16); state("in")
    unpinned("c", 60); state("c evicts b, skips in")
    s.get("in"); state("touch in")
    unpinned("d", 30); state("d")
    s.create("d", 30, pinned=True, chunk_size=16); state("pin upgrade d")
    with pytest.raises(mod.ObjectAlreadyExists):
        s.create("d", 31, pinned=True, chunk_size=16)
    s.delete("c"); state("delete c")
    s.delete("c"); state("delete c twice")
    s.put_array("in", arr(np.ones(40, np.uint8))); state("put over in-flight")
    assert inflight.failed
    with pytest.raises(mod.ObjectAlreadyExists):
        s.put_array("in", arr(np.full(40, 2, np.uint8)))
    s.put_array("in", arr(np.ones(40, np.uint8))); state("identical re-put")
    unpinned("e", 150); state("e")
    s.delete("in"); s.delete("a"); state("deletes")
    return trace


def test_node_store_steps_match_jax():
    want = _store_script(JST, {}, lambda a: a)
    got = _store_script(TST, {"device": CPU}, torch.from_numpy)
    assert got == want


def test_store_registry_membership_matches_jax():
    out = []
    for mod, kw in ((JST, {}), (TST, {"device": CPU})):
        r = mod.StoreRegistry(100, stats=mod.DataPlaneStats(), seed_ids=range(3), **kw)
        r.add(7)
        _ = r[42]  # ensure-on-access grows no membership
        old = r.replace(1)
        gone = r.remove(2)
        out.append((r.ids(), len(r), 42 in r, 7 in r, [s.node_id for s in r], old.node_id, gone.node_id,
                    r.get(99) is None, r[0].capacity_bytes))
    assert out[0] == out[1]
    assert all(s.device == CPU for s in TST.StoreRegistry(device=CPU, seed_ids=range(2)))


def test_from_array_copies_onto_the_stores_device():
    """``put_array`` copies a tensor's bytes onto the store's device: the
    store holds its own buffer, never the caller's."""
    s = TST.NodeStore(0, device=CPU)
    x = torch.arange(10, dtype=torch.float32)
    buf = s.put_array("x", x)
    assert buf.data.data_ptr() != x.data_ptr()
    x += 1
    assert torch.equal(buf.to_array(torch.float32, (10,)), torch.arange(10, dtype=torch.float32))
    b = TST.ChunkedBuffer.from_bytes(b"\x01\x02\x03", device=CPU)
    assert b.complete and b.to_bytes() == b"\x01\x02\x03"


def test_chunked_buffer_records_its_first_and_last_window():
    """``first_window_at`` is stamped when the watermark leaves 0,
    ``last_window_at`` when it reaches the size, and neither moves after;
    a buffer made complete has both at its creation."""
    raw = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    b = TST.ChunkedBuffer(256, chunk_size=64, device=CPU)
    assert (b.first_window_at, b.last_window_at) == (None, None)
    b.write_chunk(0, raw[:64])
    first = b.first_window_at
    assert first is not None and b.last_window_at is None
    time.sleep(0.002)
    b.write_chunk(64, raw[64:128])
    b.data[128:].copy_(raw[128:])
    b.write_chunk(128, None, end=256)
    assert b.first_window_at == first and b.last_window_at > first
    last = b.last_window_at
    b.write_chunk(0, None, end=256)  # no advance, no new stamp
    assert b.last_window_at == last and b.to_bytes() == bytes(raw.numpy())
    whole = TST.ChunkedBuffer.from_array(raw, device=CPU)
    assert whole.first_window_at == whole.last_window_at is not None


def test_copy_bytes_moves_host_and_typed_windows_exactly():
    """``copy_bytes`` between host tensors (a serial memcpy) gives the bytes
    ``copy_`` gives, for byte windows and for typed views (bf16 included)."""
    rng = np.random.RandomState(3)
    src = torch.from_numpy(rng.randint(0, 256, size=4096).astype(np.uint8))
    dst = torch.zeros(8192, dtype=torch.uint8)
    TST.copy_bytes(dst[100:4196], src)
    assert torch.equal(dst[100:4196], src) and int(dst[:100].sum()) == int(dst[4196:].sum()) == 0
    for dt in (torch.bfloat16, torch.float16, torch.float64):
        a = src.view(dt)
        out = torch.empty_like(a)
        TST.copy_bytes(out, a)
        assert torch.equal(out.view(torch.uint8), src)
    z = TST.zero_bytes(1000, CPU)
    assert z.dtype == torch.uint8 and z.shape == (1000,) and int(z.sum()) == 0
