"""The port's many-device and many-process paths on the CPU:
``zultra_tpu_torch.parallel`` (corpus statistics against the JAX
package's on the 8-device CPU mesh that tests/conftest.py sets up, and
independent members), ``parallel.multihost`` (the plan serialization
round trip, windows mode through a spawned worker pool and through a
real 2-rank gloo group, the gloo histogram sum, the scaling bench) and
``profiling``. Every compressed output must equal one process's
``compress_device`` byte for byte; statistics are exact integers.

The gloo group meets through a ``file://`` rendezvous under the test's
``tmp_path``, so that xdist workers share no port; every spawned run
has its own time limit."""

import gzip
import multiprocessing as mp
import zlib

import jax
import numpy as np
import pytest
import torch

from zultra_tpu.parallel import make_mesh
from zultra_tpu.parallel import sharded_corpus_stats as sharded_corpus_stats_jax
from zultra_tpu_torch import FINALIZE, Stream, compress_device
from zultra_tpu_torch.corpus import lz_data, mixed_corpus
from zultra_tpu_torch.device_pipeline import begin_window_device, emit_window_from_plan
from zultra_tpu_torch.ops import checksum
from zultra_tpu_torch.parallel import compress_corpus, multihost, sharded_corpus_stats
from zultra_tpu_torch.profiling import stage_report, stage_timer, stream_stats, trace
from zultra_tpu_torch.stream import memory_bound

# One intra-op thread in each pytest worker (see tests/test_torch_pipeline.py).
torch.set_num_threads(1)

SPAWN_TIMEOUT = 240  # seconds for a spawned group or pool to finish
DATA = mixed_corpus(2 * 32768 + 5000, seed=41)  # three windows at 32 KiB blocks
DICT = mixed_corpus(4096, seed=42)


@pytest.fixture(scope="module")
def one_process():
    """{(flags, dictionary): one process's compress_device bytes}."""
    return {(2, None): compress_device(DATA, 2, 32768, device="cpu"),
            (1, DICT): compress_device(DATA, 1, 32768, DICT, device="cpu")}


def test_sharded_corpus_stats_equals_jax():
    """Four CPU devices against the JAX step on a 4 x 2 mesh (dp x sp):
    the same window count (five, padded to 8), suffix arrays, final ranks,
    histogram and Adler partial sums."""
    assert len(jax.devices()) == 8
    data = np.random.RandomState(0).bytes(3 * 4096 + 123) + bytes(900) + lz_data(
        3500, seed=43, alpha=3).tobytes()  # five windows: three padding windows
    want = sharded_corpus_stats_jax(data, make_mesh(n_dp=4, n_sp=2), window_bytes=4096)
    got = sharded_corpus_stats(data, devices=["cpu"] * 4, window_bytes=4096)
    assert got["n_windows"] == want["n_windows"] == 8
    np.testing.assert_array_equal(got["suffix_arrays"].numpy(), np.asarray(want["suffix_arrays"]))
    np.testing.assert_array_equal(got["ranks"].numpy(), np.asarray(want["ranks"]))
    np.testing.assert_array_equal(got["corpus_histogram"], want["corpus_histogram"])
    np.testing.assert_array_equal(got["adler_s1"], np.asarray(want["adler_s1"]))
    np.testing.assert_array_equal(got["adler_s2"], np.asarray(want["adler_s2"]))
    padded = np.zeros(8 * 4096, np.uint8)
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(got["corpus_histogram"], np.bincount(padded, minlength=256))


def test_sharded_adler_partials_fold_to_zlib():
    """The per-window partial sums, folded with adler32_combine, give
    zlib's Adler-32 of the padded corpus; at 64 KiB windows, where the
    JAX step's int32 sums would wrap."""
    data = mixed_corpus(3 * 65536 + 1000, seed=44)
    stats = sharded_corpus_stats(data, devices=["cpu", "cpu"])
    L, base = 65536, checksum.ADLER_BASE
    adler = 1
    for s1, s2 in zip(stats["adler_s1"], stats["adler_s2"]):
        shard = ((int(s2 + L) % base) << 16) | (int(s1 + 1) % base)
        adler = checksum.adler32_combine(adler, shard, L)
    padded = data + bytes(stats["n_windows"] * L - len(data))
    assert adler == zlib.adler32(padded)


def test_compress_corpus_and_members():
    blobs = [mixed_corpus(3000, seed=45), lz_data(2500, seed=46, alpha=4).tobytes()]
    outs = compress_corpus(blobs, 2, 32768, workers=2, device="cpu")
    assert outs == [compress_device(b, 2, 32768, device="cpu") for b in blobs]
    assert multihost.process_info() == (0, 1)
    assert multihost.shard_blobs(blobs + [b"c"], 0, 2) == [blobs[0], b"c"]
    mine = multihost.shard_blobs(blobs, 1, 2)
    members = multihost.compress_shard_members(mine, 2, 32768, device="cpu")
    assert members == outs[1:]
    assert gzip.decompress(b"".join(outs)) == b"".join(blobs)


def test_plan_serialization_roundtrip():
    window = np.frombuffer(DATA[:32768 + 20000], np.uint8)
    handle = begin_window_device(window, 32768, 20000, device="cpu")
    blob = multihost.serialize_plan(handle)
    back = multihost.deserialize_plan(blob, window)
    assert (back.prev, back.in_size) == (handle.prev, handle.in_size)
    assert [tuple(s) for s in back.block_spans] == handle.block_spans
    for p, q in zip(back.plans, handle.plans):
        assert sorted(p) == sorted(q)
        for key, value in q.items():
            if isinstance(value, np.ndarray):
                assert p[key].dtype == value.dtype, key
            np.testing.assert_array_equal(p[key], value, err_msg=key)

    def emit(h):
        buf = bytearray(memory_bound(20000))
        n, bits_data, bits_count = emit_window_from_plan(h, True, buf, 0, 0)
        return bytes(buf[:n]), bits_data, bits_count

    assert emit(back) == emit(handle)
    with pytest.raises(ValueError):
        multihost.deserialize_plan(b"\0" * len(blob), window)
    with pytest.raises(ValueError):
        multihost.deserialize_plan(blob + b"\0", window)


def test_windows_spans_and_checksum_partials(one_process):
    spans = multihost.window_spans(len(DATA), 32768)
    assert spans == [(0, 32768), (32768, 65536), (65536, len(DATA))]
    for flags, fn in ((2, zlib.crc32), (1, zlib.adler32)):
        parts = [multihost.span_checksum_partial(DATA, lo, hi, flags) for lo, hi in spans]
        assert multihost.combine_checksum_partials(parts, flags) == fn(DATA)
    plans = multihost.plan_window_span(DATA, spans, device="cpu")
    assert multihost.stitch_window_plans(plans, 2, DATA, 32768) == one_process[(2, None)]


def test_windows_multihost_spawned_workers(one_process):
    """Two spawned planner processes with a preset dictionary (zlib)."""
    got = multihost.compress_windows_multihost(DATA, 1, 32768, workers=2, dictionary=DICT,
                                               devices=["cpu"])
    assert got == one_process[(1, DICT)]
    d = zlib.decompressobj(zdict=DICT)
    assert d.decompress(got) + d.flush() == DATA


def test_windows_distributed_two_gloo_ranks(one_process, tmp_path):
    """A real 2-rank gloo group: rank 0 stitches one process's bytes."""
    out, stats = multihost.run_windows_distributed(
        DATA, 2, 32768, world_size=2, device="cpu",
        init_method=f"file://{tmp_path / 'rendezvous'}", timeout=SPAWN_TIMEOUT)
    assert out == one_process[(2, None)]
    assert zlib.decompress(out, 31) == DATA
    assert len(stats) == 2 and "stitch_s" in stats[0] and "stitch_s" not in stats[1]
    assert all(s["plan_s"] > 0 and s["allgather_s"] >= 0 for s in stats)


def _hist_rank(rank, init_method, queue):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=2)
    try:
        local = np.arange(256, dtype=np.int64) * (rank + 1)
        total = multihost.corpus_histogram_allreduce(local)
        as_tensor = multihost.corpus_histogram_allreduce(torch.ones(4, dtype=torch.int32))
        queue.put((rank, total, as_tensor, multihost.process_info()))
    finally:
        dist.destroy_process_group()


def test_corpus_histogram_allreduce(tmp_path):
    local = np.arange(256, dtype=np.int64)
    assert multihost.corpus_histogram_allreduce(local) is local  # one process
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_hist_rank, args=(r, init, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = sorted(q.get(timeout=SPAWN_TIMEOUT) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for rank, total, as_tensor, info in results:
        np.testing.assert_array_equal(total, np.arange(256, dtype=np.int64) * 3)
        assert torch.equal(as_tensor, torch.full((4,), 2, dtype=torch.int64))
        assert info == (rank, 2)


def test_bench_scaling_runs_the_port():
    res = multihost.bench_scaling(mixed_corpus(12000, seed=48), worker_counts=(1, 2),
                                  flags=1, max_block_size=32768, device="cpu")
    assert set(res) == {1, 2}
    assert res[1]["MBps"] > 0 and res[1]["efficiency"] == 1.0 and res[2]["efficiency"] > 0


def test_profiling():
    with stage_timer("unit"):
        pass
    report = stage_report(reset=True)
    assert report["unit"]["calls"] == 1 and stage_report() == {}
    s = Stream(2, 32768, device="cpu")
    s.compress(mixed_corpus(4096, seed=49), FINALIZE)
    stats = stream_stats(s)
    assert stats["total_in"] == 4096 and 0 < stats["ratio_pct"] < 100
    assert stats["engine"] == "torchdev"
    with trace(device="cpu") as prof:
        torch.ones(8).cumsum(0)
    assert prof.key_averages()
    if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        with pytest.raises(RuntimeError):
            with trace():
                pass
