"""The port's serving entry point and the port's boundary: it serves on the
CPU only when asked to, never runs on the CPU by default, and neither the
package nor ``chip_smoke.py`` imports JAX or the JAX package."""
import ast
import pathlib

import pytest
import torch

from repro_torch.launch import serve

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--requests", "3", "--batch", "2", "--prompt-len", "8",
         "--max-new", "5"]


def test_serve_reduced_on_cpu():
    out = serve.main(SMALL + ["--device", "cpu"])
    assert out["arch"] == "qwen3-0.6b-reduced"
    assert out["device"] == "cpu" and out["requests"] == 3 and out["rounds"] == 2
    assert 2 * 4 <= out["tokens"] <= 3 * 5


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-medium"])
def test_serve_moe_and_encoder_decoder_reduced_on_cpu(arch):
    """Mixture of experts (prefill dispatches by capacity, decode takes the
    dense oracle) and the encoder-decoder (zero encoder frames, the encoder's
    K/V cached by prefill and read by decode)."""
    out = serve.main(SMALL + ["--arch", arch, "--device", "cpu"])
    assert out["arch"] == f"{arch}-reduced" and out["rounds"] == 2
    assert 2 * 4 <= out["tokens"] <= 3 * 5


def test_no_reduced_serves_the_published_width():
    out = serve.main(["--arch", "smollm-135m", "--no-reduced", "--device", "cpu",
                      "--requests", "1", "--batch", "1", "--prompt-len", "4",
                      "--max-new", "4"])
    assert out["arch"] == "smollm-135m"


def test_default_device_without_a_card_raises(monkeypatch):
    """The no-card machine is made here, whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
