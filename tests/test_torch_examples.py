"""The port's examples and its serving launcher run on the CPU at a tiny
size and say what they should (``--device cpu``; on the card they run at
their default device)."""

import runpy
from pathlib import Path

import pytest

from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    return runpy.run_path(str(EXAMPLES / name), run_name="example")["main"]


def test_torch_quickstart(capsys):
    _example("torch_quickstart.py")(["--device", "cpu", "--scale", "0.01"])
    out = capsys.readouterr().out
    assert out.count("matches brute force: True") == 2
    assert "approx p=0.8" in out


def test_torch_knn_serving(capsys):
    _example("torch_knn_serving.py")(["--device", "cpu", "--scale", "0.002"])
    out = capsys.readouterr().out
    assert "matches brute force: True" in out
    assert "matches knn_batch: True" in out
    assert "matches single-device BrePartition: True" in out
    assert "k > live_n: quality=shed reason=bad_k" in out
    assert "(must shed): quality=shed" in out


def test_torch_knnlm_decode(capsys):
    _example("torch_knnlm_decode.py")(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "kNN queries served: 72" in out
    assert "tokens equal the direct hook's: True" in out
    assert "{'target_recall': 0.9} served 8 queries" in out


@pytest.mark.parametrize("extra", [[], ["--knnlm-approx-p", "0.9"]])
def test_serve_launcher_on_the_cpu(capsys, extra):
    rc = tserve.main(["--arch", "starcoder2-3b", "--reduced", "--device",
                      "cpu", "--requests", "3", "--slots", "2",
                      "--prompt-len", "8", "--new-tokens", "4", "--knnlm",
                      *extra])
    out = capsys.readouterr().out
    assert rc == 0
    assert "3 requests, 12 tokens" in out
    assert "kNN queries served: 12" in out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_serve_launcher_serves_the_recurrent_archs(capsys, arch):
    """The recurrent families through the launcher: exact-length prompts
    (the launcher's), the hook on every sampled token."""
    rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--prompt-len", "8",
                      "--new-tokens", "4", "--knnlm"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "3 requests, 12 tokens" in out
    assert "kNN queries served: 12" in out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_serve_launcher_serves_the_moe_archs(capsys, arch):
    """The MoE configs through the launcher, the hook on every sampled
    token."""
    rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--prompt-len", "8",
                      "--new-tokens", "4", "--knnlm"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "3 requests, 12 tokens" in out
    assert "kNN queries served: 12" in out


def test_serve_launcher_refuses_an_arch_not_ported(capsys):
    """All ten configs are ported: whisper-tiny (zero frames) and
    qwen2-vl-72b (M-RoPE, zero patch embeddings) serve with the hook on
    every sampled token; only an id that names no config is refused."""
    for arch in ("whisper-tiny", "qwen2-vl-72b"):
        rc = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--prompt-len",
                          "8", "--new-tokens", "4", "--knnlm"])
        out = capsys.readouterr().out
        assert rc == 0, arch
        assert "3 requests, 12 tokens" in out, arch
        assert "kNN queries served: 12" in out, arch
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "whisper-large", "--reduced", "--device",
                     "cpu"])


def test_torch_train_lm(capsys, tmp_path):
    """The training example at the reduced config on the CPU, then again
    resumed from its last checkpoint."""
    argv = ["--device", "cpu", "--reduced", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    _example("torch_train_lm.py")(argv)
    out = capsys.readouterr().out
    assert "step    5 loss=" in out and "straggler summary:" in out
    _example("torch_train_lm.py")(argv[:4] + ["8"] + argv[5:])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 6" in out
    assert "step    7 loss=" in out


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-72b"])
def test_torch_train_lm_trains_any_arch(capsys, arch):
    """The training example with ``--arch``: the encoder-decoder and the
    M-RoPE VLM at their reduced configs, their stub inputs as zeros."""
    _example("torch_train_lm.py")(["--device", "cpu", "--reduced", "--arch",
                                   arch, "--steps", "2", "--batch", "2",
                                   "--seq", "16"])
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "straggler summary:" in out


def test_train_launcher_on_the_cpu(capsys, tmp_path):
    rec = tmp_path / "record.json"
    rc = ttrain.main(["--arch", "qwen3-32b", "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "16",
                      "--microbatches", "2", "--record", str(rec)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "step    2 loss=" in out and "3 steps in" in out
    assert "straggler: {" in out
    import json
    record = json.loads(rec.read_text())
    assert len(record["losses"]) == len(record["step_ms"]) == 3
    assert record["peak_bytes"] is None


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e",
                                  "recurrentgemma-2b", "rwkv6-1.6b",
                                  "whisper-tiny", "qwen2-vl-72b"])
def test_train_launcher_refuses_a_non_dense_arch(arch, capsys, tmp_path):
    """The launcher no longer refuses a non-dense arch: each of the MoE,
    recurrent, encoder-decoder and VLM configs trains one reduced step on
    the CPU (its stub inputs as zeros, M-RoPE positions for qwen2-vl),
    exits 0 and records a finite loss and aux loss (positive for MoE)."""
    import json
    import math
    rec = tmp_path / "record.json"
    rc = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "1", "--batch", "2", "--seq", "16",
                      "--record", str(rec)])
    assert rc == 0
    assert "step    0 loss=" in capsys.readouterr().out
    record = json.loads(rec.read_text())
    assert len(record["losses"]) == len(record["aux_losses"]) == 1
    assert all(math.isfinite(x) for x in record["losses"]
               + record["aux_losses"])
    assert (record["aux_losses"][0] > 0) == ("moe" in arch or "a16e" in arch)
