"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card unless the caller asks for the CPU, and
chip_smoke.py refuses to run without a card or outside a checkout."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core.index as tidx
import repro_torch.core.search as tsearch
from repro_torch.core.tiered import TieredPointStore

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    rng = np.random.default_rng(0)
    data = (np.abs(rng.normal(size=(96, 6))) + 0.1).astype(np.float32)
    return data, data[:3]


def test_entry_points_default_to_the_card(no_card):
    data, queries = _small()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.build_index(data, "burg", m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.build_index(data, "burg", m=2, quantize=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.brute_force_knn(data, queries, 3, "burg")
    forest = tidx.build_index(data, "burg", m=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.knn_batch(forest, queries, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.knn_search_batch(forest, queries, 3, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.forest_from_numpy(
            tidx.forest_to_numpy(forest), family_name="burg",
            partition_idx=forest.partition.idx,
            partition_mask=forest.partition.mask, d=6,
            num_clusters=forest.num_clusters)
    quantized = tidx.build_index(data, "burg", m=2, quantize=True,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.knn_batch(quantized, queries, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.forest_from_numpy(
            tidx.forest_to_numpy(quantized), family_name="burg",
            partition_idx=quantized.partition.idx,
            partition_mask=quantized.partition.mask, d=6,
            num_clusters=quantized.num_clusters, storage="int8")
    assert bool(tsearch.knn_batch(forest, queries, 3, device="cpu")
                .exact.all())
    assert bool(tsearch.knn_batch(quantized, queries, 3, device="cpu")
                .exact.all())


def test_the_third_slice_is_covered_and_defaults_to_the_card(no_card):
    """The tiered store, the prune kernels and the approximate search are
    in the import scan, and their entry points run on the card unless the
    caller asks for the CPU."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/core/tiered.py",
            "src/repro_torch/kernels/bregman_prune.py"} <= names
    data, queries = _small()
    for quantize in (False, True):
        forest = tidx.build_index(data, "burg", m=2, quantize=quantize,
                                  device="cpu")
        store = TieredPointStore.from_index(forest, resident_bytes=64,
                                            block_rows=32)
        assert not store.is_resident
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsearch.knn_search_batch_approx(forest, queries, 3, None, 0.9)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            store.search(queries, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsearch.knn_batch(store, queries, 3)
        assert bool(tsearch.knn_batch(store, queries, 3, device="cpu")
                    .exact.all())
        store.close()


def test_the_fourth_slice_is_covered_and_defaults_to_the_card(no_card):
    """The LM modules, the serving modules and kernels #9 and #10 are in
    the import scan, and their entry points run on the card unless the
    caller asks for the CPU."""
    from repro_torch import configs
    from repro_torch.models import transformer as ttf
    from repro_torch.models.attention import KVCache
    from repro_torch.models.registry import build_model
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/registry.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/starcoder2_3b.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/serve/knnlm.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/kernels/pccp_corr.py"} <= names
    cfg = configs.get_reduced("starcoder2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCache.zeros(1, 8, 2, 16)
    assert KVCache.zeros(1, 8, 2, 16, device="cpu").k.device.type == "cpu"
    params = ttf.init_params(cfg, device="cpu")
    tree = {"embed": params["embed"].numpy(),
            "final_norm": {k: v.numpy()
                           for k, v in params["final_norm"].items()},
            "layers": [{g: {k: v.numpy() for k, v in sub.items()}
                        for g, sub in lp.items()}
                       for lp in params["layers"]]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.params_from_numpy(cfg, tree)
    again = ttf.params_from_numpy(cfg, tree, device="cpu")
    assert torch.equal(again["layers"][1]["ffn"]["w_out"],
                       params["layers"][1]["ffn"]["w_out"])
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_the_mutable_index_is_covered_and_defaults_to_the_card(no_card):
    """core/segments.py is in the import scan; building a mutable index
    and searching it run on the card unless the caller asks for the CPU,
    and an insert lands on the index's own device."""
    from repro_torch.core.segments import build_segmented_index
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "src/repro_torch/core/segments.py" in names
    data, queries = _small()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_segmented_index(data, "burg", m=2)
    for quantize in (False, True):
        sf = build_segmented_index(data[:80], "burg", m=2, quantize=quantize,
                                   device="cpu")
        sf.insert(data[80:], auto_compact=False)
        sf.delete([0], auto_compact=False)
        assert sf.device.type == "cpu" and sf.view().data.device.type == "cpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsearch.knn_batch(sf, queries, 3)
        assert bool(tsearch.knn_batch(sf, queries, 3, device="cpu")
                    .exact.all())


def test_search_runs_on_the_cpu_or_the_card_only():
    data, queries = _small()
    forest = tidx.build_index(data, "burg", m=2, device="cpu")
    with pytest.raises(ValueError, match="must be a cuda or cpu device"):
        tsearch.knn_batch(forest, queries, 3, device="meta")


def _run_smoke(cwd: Path, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    for cwd, args in ((REPO, ()), (tmp_path, ()),
                      (tmp_path, ("--cpu-rehearsal",))):
        proc = _run_smoke(cwd, *args)
        assert proc.returncode != 0, (cwd, args)
        assert '"ok"' not in proc.stdout, (cwd, args)


def test_chip_smoke_cpu_rehearsal_runs_every_phase(tmp_path):
    proc = _run_smoke(REPO, "--cpu-rehearsal", "--rehearsal-n", "300",
                      "--out", str(tmp_path / "record.json"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == '{"ok": true, "rehearsal": "cpu"}'
    assert lines[-2].startswith('{"kernels": [')
    assert "ids match brute force" in proc.stdout
    for line in ("flash_attention: the 7 kernel test cases",
                 "kNN-LM: the hook's ids on the last tick match brute force",
                 "kNN-LM: the engine's",
                 "first-token logits through #10",
                 "pccp_correlation on the datastore's keys",
                 "single-query deep int8: knn == brute force",
                 "oracle blobs: knn_search_batch_reference == "
                 "knn_search_batch bit for bit",
                 "calibration: phase 2's small index",
                 "mutable deep int8: decide() would choose",
                 "mutable audio fp32: two rebuilds",
                 "mutable blob corpus: delete and reinsert",
                 "mutable kNN-LM: grow by"):
        assert line in proc.stdout, line
    names = [k["name"] for k in json.loads(lines[-2])["kernels"]]
    assert {"flash_attention", "pccp_correlation"} <= set(names)
    assert len(names) == 10
    assert (tmp_path / "record.json").exists()
