"""Rules the port (mxnet_tpu_torch/ and chip_smoke.py) must keep.

- It imports neither JAX nor the JAX package (an AST scan of every file).
- Entry points run on the card unless asked for the CPU: without CUDA,
  DecodeEngine() and TransformerDecodeModel() given no device raise.
- The kernel tier resolver keeps the JAX package's vocabulary and fails
  loudly: tier "on" with CPU tensors, "interpret" and typos raise.
- The kernel module imports, and its CPU path runs, without nvcc; a tensor
  on a device with no kernel raises instead of falling back.
"""
import ast
import os

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerDecodeModel)
from mxnet_tpu_torch.serving import DecodeEngine, tiny_lm_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and _forbidden(node.module or ""):
                bad.append((path, node.module))
    assert not bad, bad


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        DecodeEngine(tiny_lm_params(), autostart=False)
    with pytest.raises(MXNetError, match="CUDA"):
        TransformerDecodeModel(TransformerConfig(vocab_size=16, d_model=8,
                                                 num_heads=2, max_len=8))
    with pytest.raises(MXNetError, match="CUDA"):
        DecodeEngine(tiny_lm_params(), device="cuda", autostart=False)


@pytest.mark.parametrize("mode,want", [("auto", False), ("off", False),
                                       ("0", False), ("lax", False)])
def test_tier_resolves_on_cpu(mode, want):
    assert tfa.resolve_kernel_tier(mode, "cpu") is want


@pytest.mark.parametrize("mode,match", [("on", "needs CUDA"),
                                        ("1", "needs CUDA"),
                                        ("interpret", "no counterpart"),
                                        ("onn", "not understood")])
def test_tier_raises(mode, match):
    with pytest.raises(MXNetError, match=match):
        tfa.resolve_kernel_tier(mode, "cpu")


def test_model_reads_the_tier_knob(monkeypatch):
    cfg = TransformerConfig(vocab_size=16, num_layers=1, d_model=8,
                            num_heads=2, max_len=8)
    monkeypatch.setenv("MXNET_SERVING_DECODE_FLASH", "on")
    with pytest.raises(MXNetError, match="needs CUDA"):
        TransformerDecodeModel(cfg, device="cpu")
    monkeypatch.setenv("MXNET_SERVING_DECODE_FLASH", "typo")
    with pytest.raises(MXNetError, match="not understood"):
        TransformerDecodeModel(cfg, device="cpu")


def test_kernel_module_runs_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-toolkit"))
    assert _build.nvcc_path() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tfa.kernel_status() == (False, "no-nvcc")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tfa.kernel_status() == (False, "no-cuda")
    q = torch.randn(1, 2, 4, 32)
    offs = torch.tensor([0, 0], dtype=torch.int32)
    before = tfa.launches
    out, lse = tfa.flash_attention_with_lse(q, q, q, offs)
    assert out.shape == q.shape and lse.shape == (1, 2, 4)
    assert tfa.launches == before
    assert not _build._libs, "nothing may be built on a CPU call"


def test_wrapper_never_falls_back():
    q = torch.empty(1, 2, 4, 32, device="meta")
    offs = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        tfa.flash_attention_with_lse(q, q, q, offs)
    cpu_q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(MXNetError, match="not yet ported"):
        tfa.flash_attention_with_lse(cpu_q, cpu_q, cpu_q,
                                     torch.zeros(2, dtype=torch.int32),
                                     variant="grid")
