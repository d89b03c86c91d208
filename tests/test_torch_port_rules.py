"""Rules the port (mxnet_tpu_torch/ and chip_smoke.py) must keep.

- It imports neither JAX nor the JAX package (an AST scan of every file).
- Entry points run on the card unless asked for the CPU: without CUDA,
  DecodeEngine() and TransformerDecodeModel() given no device raise.
- The kernel tier resolver keeps the JAX package's vocabulary and fails
  loudly: tier "on" with CPU tensors, "interpret" and typos raise.
- The kernel module imports, and its CPU path runs, without nvcc; a tensor
  on a device with no kernel raises instead of falling back.
- The training slice: ShardedTrainStep needs CUDA unless given a device;
  what is not yet ported (half-precision kernels, the fused optimizer
  kernel, a mesh) raises instead of running something else.
"""
import ast
import os

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerDecodeModel,
                                                init_transformer,
                                                transformer_forward)
from mxnet_tpu_torch.parallel import ShardedTrainStep, mesh_kernels
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


def test_train_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        ShardedTrainStep(lambda p, b: 0.0)
    with pytest.raises(MXNetError, match="CUDA"):
        ShardedTrainStep(lambda p, b: 0.0, device="cuda")
    assert ShardedTrainStep(lambda p, b: 0.0, device="cpu").device.type \
        == "cpu"


def test_train_step_raises_on_what_is_not_ported(monkeypatch):
    loss = lambda p, b: 0.0
    with pytest.raises(MXNetError, match="kernel #7 not yet ported"):
        ShardedTrainStep(loss, fused_optupdate=True, device="cpu")
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    with pytest.raises(MXNetError, match="kernel #7 not yet ported"):
        ShardedTrainStep(loss, device="cpu")
    monkeypatch.delenv("MXNET_TPU_FUSED_OPTUPDATE")
    for flag in ("shard_update", "zero"):
        with pytest.raises(MXNetError, match="'dp' mesh axis"):
            ShardedTrainStep(loss, device="cpu", **{flag: True})
    with pytest.raises(MXNetError, match="not yet ported"):
        ShardedTrainStep(loss, mesh=object(), device="cpu")


def test_transformer_forward_with_a_mesh_raises():
    cfg = TransformerConfig(vocab_size=16, num_layers=1, d_model=32,
                            num_heads=1, max_len=8)
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(MXNetError, match="distribution is not yet ported"):
        transformer_forward(params, torch.zeros(1, 4, dtype=torch.int64),
                            cfg, mesh=object())


def test_flash_attention_never_falls_back():
    q = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        tfa.flash_attention(q, q, q, causal=True)
    with pytest.raises(MXNetError, match="no kernel"):
        tfa._FlashAttention.apply(q, q, q, 0.5, True)
    cpu_q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(MXNetError, match="no counterpart"):
        tfa.flash_attention(cpu_q, cpu_q, cpu_q, interpret=True)
    with pytest.raises(MXNetError, match="not yet ported"):
        tfa.flash_attention(cpu_q, cpu_q, cpu_q, variant="grid")
    with pytest.raises(MXNetError, match="needs CUDA"):
        tfa.flash_attention(cpu_q, cpu_q, cpu_q, use_pallas=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_wrappers_refuse_half_precision(dtype):
    """The CUDA wrappers check before they build or launch anything: half
    precision raises "not yet ported", never a silent cast."""
    q = torch.zeros(1, 2, 4, 64, dtype=dtype)
    offs = torch.zeros(2, dtype=torch.int32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(MXNetError, match="not yet ported"):
        tfa._flash_fwd_cuda(q, q, q, 0.125, True)
    with pytest.raises(MXNetError, match="not yet ported"):
        tfa._flash_fwd_offs_cuda(q, q, q, offs, 0.125, True)
    with pytest.raises(MXNetError, match="not yet ported"):
        tfa._flash_bwd_cuda(q, q, q, offs, q, lse, lse, 0.125, True)
    assert not _build._libs


def test_kernel_wrappers_check_shapes_and_layout():
    q = torch.zeros(1, 2, 4, 48)
    with pytest.raises(MXNetError, match="head dim 48"):
        tfa._flash_fwd_cuda(q, q, q, 0.125, True)
    q = torch.zeros(1, 4, 2, 64).transpose(1, 2)
    with pytest.raises(MXNetError, match="not contiguous"):
        tfa._flash_fwd_cuda(q, q, q, 0.125, True)
    assert not _build._libs


@pytest.mark.parametrize("mode,want", [("auto", False), ("off", False),
                                       ("0", False)])
def test_mesh_kernel_tier_knob(monkeypatch, mode, want):
    monkeypatch.setenv("MXNET_TPU_MESH_KERNEL_TIER", mode)
    assert mesh_kernels.kernel_tier_mode() == mode
    assert mesh_kernels.resolve_kernel_tier(device="cpu") is want


@pytest.mark.parametrize("mode,match", [("interpret", "no counterpart"),
                                        ("onn", "not understood"),
                                        ("on", "needs CUDA")])
def test_mesh_kernel_tier_knob_raises(monkeypatch, mode, match):
    monkeypatch.setenv("MXNET_TPU_MESH_KERNEL_TIER", mode)
    with pytest.raises(MXNetError, match=match):
        mesh_kernels.resolve_kernel_tier(device="cpu")
