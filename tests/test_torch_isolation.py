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
    REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))


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


def test_the_serving_slice_is_covered_and_defaults_to_the_card(no_card):
    """The autotuner, the fault harness, the retrieval service, the serving
    launcher and the three torch examples are in the import scan; the
    launcher, the examples and the datastore build run on the card unless
    the caller asks for the CPU, and a service runs each tenant on its
    index's device."""
    import runpy

    from repro_torch.launch import serve as tserve
    from repro_torch.serve import RetrievalService
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/launch/autotune.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/serve/faults.py",
            "src/repro_torch/serve/retrieval.py",
            "examples/torch_quickstart.py",
            "examples/torch_knn_serving.py",
            "examples/torch_knnlm_decode.py"} <= names
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "starcoder2-3b", "--reduced"])
    for example in ("torch_quickstart.py", "torch_knn_serving.py",
                    "torch_knnlm_decode.py"):
        main = runpy.run_path(str(REPO / "examples" / example),
                              run_name="example")["main"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    data, queries = _small()
    forest = tidx.build_index(data, "burg", m=2, device="cpu")
    svc = RetrievalService()
    assert svc.register_tenant("t", forest).device.type == "cpu"
    assert svc.search_sync("t", queries, 3).quality == "exact"


def test_the_recurrent_slice_is_covered_and_defaults_to_the_card(no_card):
    """The recurrent mixers and their configs are in the import scan; the
    state constructors, init_cache and build_model run on the card unless
    the caller asks for the CPU."""
    from repro_torch import configs
    from repro_torch.models import rglru, rwkv
    from repro_torch.models import transformer as ttf
    from repro_torch.models.registry import build_model
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/models/rglru.py",
            "src/repro_torch/models/rwkv.py",
            "src/repro_torch/configs/recurrentgemma_2b.py",
            "src/repro_torch/configs/rwkv6_1_6b.py"} <= names
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rglru.rglru_state_zeros(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rwkv.rwkv_state_zeros(1, 8, 4)
    assert rglru.rglru_state_zeros(1, 8, device="cpu")["h"].device.type \
        == "cpu"
    assert rwkv.rwkv_state_zeros(1, 8, 4, device="cpu")["time"]["wkv"] \
        .device.type == "cpu"
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b"):
        cfg = configs.get_reduced(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttf.init_cache(cfg, 1, 8)
        bundle = build_model(cfg, device="cpu")
        leaves = [t for layer in bundle.init_cache(1, 8)
                  for part in (layer["mixer"], layer["ffn"])
                  if part is not None
                  for t in (part if isinstance(part, tuple)
                            else part.values())]
        assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_the_moe_slice_is_covered_and_defaults_to_the_card(no_card):
    """models/moe.py and the five MoE and dense configs are in the import
    scan; build_model, init_params and init_cache of each run on the card
    unless the caller asks for the CPU, and the MoE layer runs on its
    input's device."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttf
    from repro_torch.models.registry import build_model
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    archs = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "qwen2.5-32b",
             "qwen3-32b", "phi3-medium-14b")
    assert {"src/repro_torch/models/moe.py"} | {
        f"src/repro_torch/configs/{a.replace('-', '_').replace('.', '_')}"
        ".py" for a in archs} <= names
    for arch in archs:
        cfg = configs.get_reduced(arch)
        for call in (lambda: build_model(cfg), lambda: ttf.init_params(cfg),
                     lambda: ttf.init_cache(cfg, 1, 8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    cfg = configs.get_reduced("llama4-scout-17b-a16e")
    params = build_model(cfg, device="cpu").init(0)
    ffn = params["layers"][0]["ffn"]
    assert ffn["w_in"].device.type == "cpu"
    y, aux = moe.apply_moe({k: v for k, v in ffn.items() if k != "shared"},
                           torch.ones((1, 4, cfg.d_model)), cfg.moe,
                           shared_mlp=ffn["shared"])
    assert y.device.type == "cpu" and aux.device.type == "cpu"


def test_the_encdec_slice_is_covered_and_defaults_to_the_card(no_card):
    """models/encdec.py and the whisper-tiny and qwen2-vl-72b configs are in
    the import scan; build_model, init_params, init_cache and KVCache run
    on the card unless the caller asks for the CPU; the extra inputs the
    engine and the datastore feed are made on the bundle's device."""
    from repro_torch import configs
    from repro_torch.models import encdec
    from repro_torch.models import transformer as ttf
    from repro_torch.models.registry import build_model, model_inputs
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/models/encdec.py",
            "src/repro_torch/configs/whisper_tiny.py",
            "src/repro_torch/configs/qwen2_vl_72b.py"} <= names
    whisper = configs.get_reduced("whisper-tiny")
    vlm = configs.get_reduced("qwen2-vl-72b")
    for call in (lambda: build_model(whisper), lambda: build_model(vlm),
                 lambda: encdec.init_params(whisper),
                 lambda: encdec.init_cache(whisper, 1, 8),
                 lambda: ttf.init_params(vlm),
                 lambda: ttf.init_cache(vlm, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for cfg in (whisper, vlm):
        bundle = build_model(cfg, device="cpu")
        batch = model_inputs(bundle, torch.ones((2, 8), dtype=torch.int32),
                             torch.arange(8)[None].expand(2, 8))
        assert all(t.device.type == "cpu" for t in batch.values())
        caches = bundle.init_cache(2, 8)
        hidden, _ = bundle.prefill(bundle.init(0), batch, caches,
                                   torch.zeros(2, dtype=torch.int32))
        assert hidden.device.type == "cpu"
    assert caches[0]["mixer"].k.device.type == "cpu"


def test_the_distributed_slice_is_covered_and_defaults_to_the_card(no_card):
    """dist/ and launch/mesh.py are in the import scan; make_mesh, the
    host and production meshes, query_subview, shard_index and
    distributed_knn run on the card unless the caller asks for the CPU,
    and the CPU's group is gloo."""
    import torch.distributed as dist
    from repro_torch.dist import knn as dk
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import mesh as lmesh
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/dist/__init__.py",
            "src/repro_torch/dist/sharding.py",
            "src/repro_torch/dist/knn.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/core/baselines.py"} <= names
    assert not dist.is_initialized()
    for call in (lambda: make_mesh((1,), ("data",)),
                 lambda: lmesh.make_host_mesh(),
                 lambda: lmesh.make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()
    data, queries = _small()
    forest = tidx.build_index(data, "burg", m=2, device="cpu")
    mesh = make_mesh((1,), ("data",), device="cpu")
    try:
        assert dist.get_backend() == "gloo" and lmesh.mesh_chips(mesh) == 1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dk.shard_index(forest, mesh)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dk.query_subview(forest.partition, queries)
        sharded = dk.shard_index(forest, mesh, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dk.distributed_knn(sharded, queries, family="burg", k=3,
                               budget=None)
        res = dk.distributed_knn(sharded, queries, family="burg", k=3,
                                 budget=None, device="cpu")
        assert bool(res.exact.all())
    finally:
        dist.destroy_process_group()


def test_the_training_slice_is_covered_and_defaults_to_the_card(no_card,
                                                               tmp_path):
    """train/, launch/train.py and the training example are in the import
    scan; the token stream, the train state, the bundle's training
    forward, the state carried across from numpy, the checkpoint's
    restore and the launcher run on the card unless the caller asks for
    the CPU."""
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig, token_batch
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tloop
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/train/__init__.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/losses.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/straggler.py",
            "src/repro_torch/train/train_loop.py",
            "src/repro_torch/launch/train.py",
            "examples/torch_train_lm.py"} <= names
    cfg = configs.get_reduced("starcoder2-3b")
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=2)
    bundle = build_model(cfg, device="cpu")
    state = tloop.init_train_state(bundle, 0)
    tree = topt.tree_map(lambda t: t.detach().numpy(), state)
    ckpt.save_checkpoint(str(tmp_path), 0, state)
    for call in (lambda: token_batch(stream, 0),
                 lambda: tloop.init_train_state(build_model(cfg), 0),
                 lambda: tloop.train_state_from_numpy(cfg, tree),
                 lambda: ckpt.restore_checkpoint(str(tmp_path), 0, state),
                 lambda: tlaunch.main(["--arch", "starcoder2-3b",
                                       "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    batch = token_batch(stream, 0, device="cpu")
    hidden, _ = bundle.forward_autograd(state.params, batch)
    assert hidden.device.type == "cpu" and hidden.requires_grad
    step = tloop.make_train_step(bundle, tloop.TrainConfig())
    state, metrics = step(state, batch)
    assert metrics["loss"].device.type == "cpu"


def test_the_training_families_default_to_the_card(no_card, tmp_path):
    """The MoE, recurrent, encoder-decoder and VLM configs train through
    the same entry points, which run on the card unless the caller asks
    for the CPU: the launcher, the train state, the state carried across
    from numpy (the encoder-decoder's tree through its own import) and
    the step's batches."""
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_loop as tloop
    for arch in ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "whisper-tiny",
                 "qwen2-vl-72b"):
        cfg = configs.get_reduced(arch)
        bundle = build_model(cfg, device="cpu")
        state = tloop.init_train_state(bundle, 0)
        tree = topt.tree_map(lambda t: t.detach().numpy(), state)
        stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                   global_batch=2)
        for call in (lambda: tloop.init_train_state(build_model(cfg), 0),
                     lambda: tloop.train_state_from_numpy(cfg, tree),
                     lambda: tloop.train_batch(build_model(cfg), stream, 0),
                     lambda: tlaunch.main(["--arch", arch, "--reduced",
                                           "--steps", "1"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        back = tloop.train_state_from_numpy(cfg, tree, device="cpu")
        batch = tloop.train_batch(bundle, stream, 0)
        assert all(v.device.type == "cpu" for v in batch.values())
        hidden, _ = bundle.forward_autograd(back.params, batch)
        assert hidden.device.type == "cpu" and hidden.requires_grad


def test_the_sharding_slice_is_covered_and_defaults_to_the_card(no_card):
    """configs/common.py and dist/'s sharding rules, collective matmuls,
    compression and pipeline are in the import scan; a sharded train
    state, its step's batches and the launcher's mesh run on the card
    unless the caller asks for the CPU."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig, token_batch
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.registry import build_model
    from repro_torch.train import train_loop as tloop
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/configs/common.py",
            "src/repro_torch/dist/collective_matmul.py",
            "src/repro_torch/dist/compression.py",
            "src/repro_torch/dist/pipeline.py"} <= names
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    assert not dist.is_initialized()
    cfg = configs.get_reduced("starcoder2-3b")
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=8,
                               global_batch=2)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    try:
        for call in (lambda: token_batch(stream, 0, mesh=mesh),
                     lambda: tloop.init_train_state(build_model(cfg), 0,
                                                    mesh=mesh)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        bundle = build_model(cfg, device="cpu")
        state = tloop.init_train_state(bundle, 0, mesh=mesh)
        assert state.params["embed"].device.type == "cpu"
        batch = tloop.train_batch(bundle, stream, 0, mesh=mesh)
        assert all(v.device.type == "cpu" for v in batch.values())
    finally:
        dist.destroy_process_group()
    monkey_env = {"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in monkey_env}
    os.environ.update(monkey_env)
    try:
        # under torchrun the launcher's mesh is made on the card first
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "starcoder2-3b", "--reduced"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert not dist.is_initialized()


def test_the_baselines_are_host_code_by_design(no_card):
    """core/baselines.py is the one entry point with no device: the paper's
    comparison points run in numpy on the host, "not the accelerated
    path" (reference core/baselines.py:11-12), with or without a card."""
    from repro_torch.core import baselines
    src = (REPO / "src" / "repro" / "core" / "baselines.py").read_text()
    assert "not the accelerated path" in src.splitlines()[11]
    data, _ = _small()
    for tree in (baselines.BBTree(data, "burg", leaf_size=16),
                 baselines.BBTree(data, "burg", leaf_size=16,
                                  bound="tuple")):
        ids, dists, _ = tree.knn(data[0], 3)
        assert isinstance(ids, np.ndarray) and ids[0] == 0
    ids, _, _ = baselines.VAFile(data, "burg").knn(data[1], 3)
    assert ids[0] == 1
    assert baselines.linear_scan(data, data[2], 3, "burg")[0][0] == 2


def test_search_runs_on_the_cpu_or_the_card_only():
    data, queries = _small()
    forest = tidx.build_index(data, "burg", m=2, device="cpu")
    with pytest.raises(ValueError, match="must be a cuda or cpu device"):
        tsearch.knn_batch(forest, queries, 3, device="meta")


def _run_smoke(cwd: Path, *args):
    # One intra-op thread: the rehearsal's ops are tiny, and beside the
    # other test workers torch's default pool spins against them, which
    # ran the rehearsal past the 600 s limit below.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
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
                 "mutable kNN-LM: grow by",
                 "service deep fp32: 48 requests exact",
                 "service deep int8: 48 requests exact",
                 "service deep fp32 faults: a launch error retried",
                 "every plan fired its expected events",
                 "service deep fp32 wall clock: 128 requests",
                 "service blobs (tiered",
                 "autotune: blob corpus",
                 "kNN-LM service route: the engine's",
                 "kNN-LM hook at target_recall=0.9",
                 "serve launcher (--arch starcoder2-3b",
                 "autotune: the table's",
                 "phase 11:",
                 "distributed deep fp32: world 1 over gloo",
                 "distributed deep int8: world 1 over gloo",
                 "distributed deep fp32 approx",
                 "distributed mutable deep fp32",
                 "distributed service deep fp32: 48 requests",
                 "baselines audio",
                 "phase 12:",
                 "flash_attention D=256 rg_window_4096",
                 "recurrentgemma-2b: the engine's",
                 "recurrentgemma-2b: the hook's ids on the last tick match",
                 "recurrentgemma-2b: 8 requests re-admitted into used slots",
                 "recurrentgemma-2b: first-token logits through #10",
                 "rwkv6-1.6b: the engine's",
                 "rwkv6-1.6b: 8 requests re-admitted into used slots",
                 "phase 13:",
                 "flash_attention moe_corpus_batch",
                 "qwen3-moe-30b-a3b: the engine's",
                 "qwen3-moe-30b-a3b: the hook's ids on the last tick match",
                 "qwen3-moe-30b-a3b: MoE layer 0 in fp32 on the card equals",
                 "qwen3-moe-30b-a3b: first-token logits through #10",
                 "llama4-scout-17b-a16e: 2 layers at full width",
                 "qwen2.5-32b: 2 layers at full width",
                 "qwen3-32b: 2 layers at full width",
                 "phi3-medium-14b: 2 layers at full width",
                 "phase 14:",
                 "flash_attention whisper_encoder",
                 "flash_attention qwen2vl_corpus_batch",
                 "whisper-tiny: the engine's",
                 "whisper-tiny: the hooked logits of all",
                 "whisper-tiny: the hook's ids on the last tick match",
                 "whisper-tiny: first-token logits through #10",
                 "qwen2-vl-72b: the engine's",
                 "qwen2-vl-72b: the hook's ids on the last tick match",
                 "qwen2-vl-72b: first-token logits through #10",
                 "phase 15:",
                 "train starcoder2-3b: 2 layers, 4 x 64 tokens in 2 "
                 "microbatches, 4 steps through launch/train.py (exit 0)",
                 "train card vs cpu: starcoder2-3b at 2 layers, fp32",
                 "train restart: starcoder2-3b at 2 layers, bf16",
                 "phase 16:",
                 "train rwkv6-1.6b: 2 layers, 4 x 64 tokens in 2 "
                 "microbatches, 4 steps through launch/train.py (exit 0)",
                 "train recurrentgemma-2b: 3 layers, 4 x 64 tokens in 2 "
                 "microbatches, 4 steps through launch/train.py (exit 0)",
                 "train qwen3-moe-30b-a3b: 2 layers, 4 x 64 tokens in 2 "
                 "microbatches, 3 steps through make_train_step; losses",
                 "train whisper-tiny: 4 layers, 8 x 64 tokens in 2 "
                 "microbatches, 5 steps through launch/train.py (exit 0)",
                 "train restart: whisper-tiny at 4 layers, bf16, 8 x 64",
                 "train qwen2-vl-72b: 2 layers, 1 x 64 tokens in 1 "
                 "microbatches, 2 steps through make_train_step",
                 *(f"train card vs cpu: {arch} at" for arch in (
                     "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
                     "recurrentgemma-2b", "rwkv6-1.6b", "whisper-tiny",
                     "qwen2-vl-72b")),
                 "(6 leaves without a gradient)",
                 "phase 17:",
                 "sharded substrates at p = 1",
                 *(f"sharded step {arch} (reduced, fp32) on the (1, 1) mesh:"
                   " 2 steps bit-equal to the mesh-less step" for arch in (
                       "starcoder2-3b", "qwen3-moe-30b-a3b")),
                 "train starcoder2-3b: 2 layers, 4 x 64 tokens in 2 "
                 "microbatches, 3 steps through make_train_step on a (1,) "
                 "data mesh",
                 "phase 18c against 16a: losses bit-equal",
                 "phase 18:"):
        assert line in proc.stdout, line
    names = [k["name"] for k in json.loads(lines[-2])["kernels"]]
    assert {"flash_attention", "pccp_correlation"} <= set(names)
    assert len(names) == 10
    assert (tmp_path / "record.json").exists()
