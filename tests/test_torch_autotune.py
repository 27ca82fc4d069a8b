"""The port's autotuner (launch/autotune.py) against the reference's.

The lookup is held to ``repro.launch.autotune.lookup`` on the same
synthetic tables with explicit backend strings; the checked-in port table
is swept on the card and keyed ``cuda`` only, so every CPU lookup misses
it and CPU searches keep block size 4096.
"""

import json

import numpy as np
import pytest

from repro.launch import autotune as jautotune

from repro_torch.core import index as tidx
from repro_torch.core import search as tsearch
from repro_torch.launch import autotune


def _entry(**kw):
    e = {"backend": "cuda", "storage": "f32",
         "n_log2": 12.0, "q_log2": 3.0, "d": 32, "m": 8,
         "block_rows": 2048, "env_block_rows": 512,
         "us_per_call": 100.0, "temp_bytes": 1 << 20}
    e.update(kw)
    return e


TABLES = {
    "two": (_entry(n_log2=12.0, q_log2=3.0, block_rows=2048),
            _entry(n_log2=14.0, q_log2=6.0, block_rows=8192)),
    "backends": (_entry(backend="cpu", block_rows=1024),
                 _entry(backend="cuda", block_rows=4096),
                 _entry(backend="tpu", block_rows=16384)),
    "storages": (_entry(storage="int8", block_rows=4096, n_log2=16.0),
                 _entry(storage="f32", block_rows=2048, n_log2=16.0,
                        q_log2=6.0),
                 _entry(storage="f32", block_rows=8192, n_log2=20.0)),
    "malformed": ({"backend": "cuda"}, _entry(block_rows="not_an_int"),
                  _entry(block_rows=2), _entry(n_log2=None),
                  _entry(block_rows=1024)),
    "ties": (_entry(n_log2=12.0, q_log2=3.0, block_rows=1024),
             _entry(n_log2=12.0, q_log2=3.0, block_rows=2048),
             _entry(n_log2=13.0, q_log2=6.0, block_rows=4096)),
}

QUERIES = [(n, q, storage, backend)
           for n in (0, 1, 1000, 4096, 6000, 12000, 16384, 65472, 10**6,
                     2**30)
           for q in (None, 1, 8, 50, 64)
           for storage in (None, "f32", "int8")
           for backend in ("cpu", "cuda", "tpu")]


@pytest.mark.parametrize("table", sorted(TABLES))
def test_lookup_matches_the_reference(table):
    entries = TABLES[table]
    for n, q, storage, backend in QUERIES:
        kw = dict(storage=storage, backend=backend, table=entries)
        assert autotune.lookup(n, q, **kw) == jautotune.lookup(n, q, **kw), (
            n, q, storage, backend)
        assert autotune.lookup_block_rows(n, q, **kw) == \
            jautotune.lookup_block_rows(n, q, **kw)
        assert autotune.lookup_env_block_rows(n, q, **kw) == \
            jautotune.lookup_env_block_rows(n, q, **kw)


def test_lookup_semantics():
    table = TABLES["two"]
    assert autotune.lookup_block_rows(4096, 8, table=table,
                                      backend="cuda") == 2048
    assert autotune.lookup_block_rows(12000, 64, table=table,
                                      backend="cuda") == 8192
    assert autotune.lookup_block_rows(4096, table=table,
                                      backend="cuda") == 2048
    far = 2 ** (12 + autotune.MAX_N_LOG2_DISTANCE + 1)
    assert autotune.lookup_block_rows(int(far), 8, table=table[:1],
                                      backend="cuda") is None
    # The backend follows the device when none is named.
    assert autotune.lookup_block_rows(4096, 8, table=table,
                                      device="cpu") is None
    assert autotune.lookup_block_rows(4096, 8, table=table,
                                      device="cuda") == 2048
    assert autotune.device_backend("cpu") == "cpu"
    assert (autotune.MAX_N_LOG2_DISTANCE, autotune.CANDIDATE_BLOCK_ROWS,
            autotune.CANDIDATE_ENV_BLOCK_ROWS) == (
        jautotune.MAX_N_LOG2_DISTANCE, jautotune.CANDIDATE_BLOCK_ROWS,
        jautotune.CANDIDATE_ENV_BLOCK_ROWS)


@pytest.fixture
def table_env(tmp_path, monkeypatch):
    """Point the port's table at a temporary file."""
    path = tmp_path / "table.json"
    monkeypatch.setenv(autotune.TABLE_ENV, str(path))
    autotune._load_table_cached.cache_clear()
    yield path
    autotune._load_table_cached.cache_clear()


def test_load_table_missing_and_corrupt(table_env):
    assert autotune.load_table() == ()
    for text in ("{not json", "[1, 2]", '{"entries": 3}', ""):
        table_env.write_text(text)
        autotune._load_table_cached.cache_clear()
        assert autotune.load_table() == (), text


def test_write_then_load_roundtrip(table_env):
    autotune.write_table([_entry(), "junk"], table_env, note="test")
    entries = autotune.load_table()
    assert entries == (_entry(),)
    payload = json.loads(table_env.read_text())
    assert payload["version"] == 1 and payload["note"] == "test"
    assert payload["entries"][0]["block_rows"] == 2048
    # The reference reads the port's file format too.
    assert jautotune.load_table(table_env) == entries


def test_checked_in_table_is_well_formed_and_cuda_only():
    """Swept on the card: every entry is ``cuda``, resolves through the
    lookup, and the note names the card and the command."""
    assert autotune.DEFAULT_TABLE_PATH.exists()
    payload = json.loads(autotune.DEFAULT_TABLE_PATH.read_text())
    entries = autotune.load_table(autotune.DEFAULT_TABLE_PATH)
    assert entries and len(entries) == len(payload["entries"])
    assert "H100" in payload["note"]
    assert "repro_torch.launch.autotune" in payload["note"]
    for e in entries:
        assert e["backend"] == "cuda" and e["storage"] in ("f32", "int8")
        n = int(round(2 ** float(e["n_log2"])))
        q = int(round(2 ** float(e["q_log2"])))
        got = autotune.lookup(n, q, storage=e["storage"], backend="cuda",
                              table=entries)
        assert got == e
        assert int(e["block_rows"]) in autotune.CANDIDATE_BLOCK_ROWS
        assert int(e["env_block_rows"]) % tidx.ENV_BLOCK_ROWS == 0
        assert e["temp_bytes"] is None or e["temp_bytes"] > 0
        assert e["us_per_call"] > 0
    # The shapes the port serves hit it on the card, miss it on the CPU.
    for n, q in ((10**6, 50), (65472, 8), (54387, 32), (2**20, 32)):
        for storage in ("f32", "int8"):
            assert autotune.lookup_block_rows(
                n, q, storage=storage, backend="cuda",
                table=entries) is not None
            assert autotune.lookup_block_rows(
                n, q, storage=storage, device="cpu", table=entries) is None


def test_resolve_block_rows_consults_table(table_env):
    autotune.write_table(
        [_entry(n_log2=12.0, q_log2=3.0, block_rows=1536),
         _entry(backend="cpu", n_log2=12.0, q_log2=3.0, block_rows=768)],
        table_env)
    rbr = tsearch.resolve_block_rows
    assert rbr(None, 4096, q=8, storage="f32", device="cuda") == 1536
    assert rbr(None, 4096, q=8, storage="f32", device="cpu") == 768
    assert rbr(777, 4096, q=8, storage="f32", device="cpu") == 777
    assert rbr(None, 4096, q=8, storage="int8",
               device="cpu") == tsearch.DEFAULT_BLOCK_ROWS
    assert rbr(None, 10**9, q=8, storage="f32",
               device="cpu") == tsearch.DEFAULT_BLOCK_ROWS
    with pytest.raises(ValueError, match="empty"):
        rbr(None, 0, q=8, storage="f32", device="cpu")


def test_the_checked_in_table_misses_on_the_cpu():
    """CPU parity keeps 4096: the port's own table speaks only for cuda."""
    autotune._load_table_cached.cache_clear()
    for n, q in ((10**6, 50), (65472, 8), (4096, 8)):
        for storage in ("f32", "int8"):
            assert tsearch.resolve_block_rows(
                None, n, q=q, storage=storage,
                device="cpu") == tsearch.DEFAULT_BLOCK_ROWS


def test_search_results_identical_with_and_without_table(table_env):
    """A table pick changes the block size, never the answer, on the
    search and on the tiered store built without a block size."""
    from repro_torch.core.tiered import TieredPointStore
    rng = np.random.default_rng(0)
    data = rng.normal(size=(600, 16)).astype(np.float32)
    index = tidx.build_index(data, "squared_euclidean", m=4,
                             num_clusters=8, seed=0, device="cpu")
    ys = rng.normal(size=(4, 16)).astype(np.float32)
    base = tsearch.knn_search_batch(index, ys, 5, 64,
                                    block_rows=tsearch.DEFAULT_BLOCK_ROWS,
                                    device="cpu")
    autotune.write_table(
        [_entry(backend="cpu", n_log2=9.23, q_log2=2.0, block_rows=128,
                env_block_rows=512)], table_env)
    assert tsearch.resolve_block_rows(None, index.n, q=4,
                                      storage=index.storage,
                                      device="cpu") == 128
    tuned = tsearch.knn_search_batch(index, ys, 5, 64, device="cpu")
    approx = tsearch.knn_batch(index, ys, 5, approx_p=0.9, device="cpu")
    store = TieredPointStore.from_index(index, resident_bytes=4096)
    assert store.block_rows == 128
    tiered = tsearch.knn_search_batch(store, ys, 5, 64, device="cpu")
    for got in (tuned, tiered):
        for f in ("ids", "dists", "exact", "num_candidates"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(base, f).numpy())
    store.close()
    autotune._load_table_cached.cache_clear()
    table_env.unlink()
    again = tsearch.knn_batch(index, ys, 5, approx_p=0.9, device="cpu")
    for f in ("ids", "dists", "exact", "num_candidates"):
        np.testing.assert_array_equal(getattr(again, f).numpy(),
                                      getattr(approx, f).numpy())


def test_tiny_cpu_sweep_and_cli(tmp_path):
    """A sweep on the CPU: one entry per cell, no memory probe there."""
    cfg = autotune.SweepConfig(ns=(512,), qs=(4,), d=8, m=2,
                               storages=("f32", "int8"),
                               block_rows_candidates=(128, 256, 2048),
                               env_candidates=(256, 512), repeats=1,
                               device="cpu")
    lines = []
    entries = autotune.sweep(cfg, log=lines.append)
    assert [e["storage"] for e in entries] == ["f32", "int8"]
    for e in entries:
        assert e["backend"] == "cpu" and e["temp_bytes"] is None
        assert e["block_rows"] in (128, 256)       # 2048 > 2n is skipped
        assert e["env_block_rows"] in (256, 512) and e["us_per_call"] > 0
        assert (e["n_log2"], e["q_log2"], e["d"], e["m"]) == (9.0, 2.0, 8, 2)
    assert sum("br=2048" in line for line in lines) == 0
    out = tmp_path / "t.json"
    assert autotune.main(["--device", "cpu", "--n", "256", "--q", "2",
                          "--d", "8", "--m", "2", "--storages", "f32",
                          "--block-rows", "128", "--env-block-rows", "256",
                          "--repeats", "1", "--no-time",
                          "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert len(payload["entries"]) == 1
    assert payload["entries"][0]["us_per_call"] == float("inf")
    assert "repro_torch.launch.autotune" in payload["note"]
