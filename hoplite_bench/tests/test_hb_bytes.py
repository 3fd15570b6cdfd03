"""The byte counts of the roofline shares, against hand-worked values."""

from hoplite_bench import harness
from hoplite_bench.tests.conftest import ROOT

GIB = 1 << 30


def reader(name):
    return harness.Bench(ROOT).reader(name)


def test_chunk_reduce_least_bytes():
    # 8 inputs of 1 GiB read once, the result written once: 9 GiB = 9.66 GB.
    assert reader("chunk_reduce_roofline").least_bytes("allreduce", 8, GIB) == 9 * GIB == 9_663_676_416
    assert reader("chunk_reduce_roofline").least_bytes("reduce", 8, GIB) == 9 * GIB
    assert reader("chunk_reduce_roofline").least_bytes("broadcast", 8, GIB) == 0


def test_collective_least_bytes():
    # allreduce: 8 inputs read, 8 results written: 16 GiB = 17.18 GB, 5.13 ms at 3.35 TB/s.
    r = reader("collective_hbm_pct")
    assert r.least_bytes("allreduce", 8, GIB) == 16 * GIB == 17_179_869_184
    assert abs(17_179_869_184 / 3.35e12 * 1e3 - 5.128) < 1e-3
    assert r.least_bytes("reduce", 8, GIB) == 9 * GIB
    assert r.least_bytes("broadcast", 8, GIB) == 8 * GIB


def test_round_least_bytes():
    # 4 gradients: a 16 x 25,557,032 f32 shard read (1,635,650,048 B), w read
    # and g written (204,456,256 B); the 4-way reduce reads 4 and writes 1
    # (511,140,640 B); the update reads 2 and writes 1 (306,684,384 B).
    d = 25_557_032
    want = 4 * (1_635_650_048 + 204_456_256) + 511_140_640 + 306_684_384
    assert want == 8_178_250_240
    assert reader("round_hbm_pct").least_bytes(d, 16, 4) == want
    assert abs(want / 3.35e12 * 1e3 - 2.441) < 1e-3


def test_roofline_shares_from_a_trace():
    """A reading on a made-up trace: 10 collectives in 1 s, 0.2 s of
    chunk_reduce time, 0.5 s busy."""
    bench = harness.Bench(ROOT)
    cell = bench.cell("allreduce-1gib")
    w = harness.Window(start=0.0, close=1.0, completed=10, samples_ms=[100.0] * 10)
    t = harness.Trace(window_s=1.0, busy_s=0.5, ops={"chunk_reduce_kernel<float>": (0.2, 70), "Memcpy DtoD": (0.3, 70)},
                      idle={})
    r = harness.Reading(cell, w, harness.Spans(), t, 3.35e12)
    assert abs(bench.reader("chunk_reduce_roofline").read(r) - 100 * 10 * 9 * GIB / 3.35e12 / 0.2) < 1e-9
    assert abs(bench.reader("collective_hbm_pct").read(r) - 100 * 10 * 16 * GIB / 3.35e12 / 1.0) < 1e-9
    assert bench.reader("device_idle_pct.collective").read(r) == 50.0
    assert bench.reader("device_idle_pct.asgd").read(r) == 50.0
    # No peak for the device, or no trace: the shares are left out, never 0.
    assert bench.reader("collective_hbm_pct").read(harness.Reading(cell, w, harness.Spans(), t, None)) is None
    assert bench.reader("chunk_reduce_roofline").read(harness.Reading(cell, w, harness.Spans(), None, 3.35e12)) is None


def test_percentile_wants_ten_samples_beyond_it():
    assert harness.percentile(list(range(1, 201)), 95) == 190
    assert harness.percentile(list(range(1, 199)), 95) is None
