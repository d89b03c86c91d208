"""Rules the port (mxnet_tpu_torch/ and chip_smoke.py) must keep.

- It imports neither JAX nor the JAX package (an AST scan of every file).
- Entry points run on the card unless asked for the CPU: without CUDA,
  DecodeEngine() and TransformerDecodeModel() given no device raise.
- The kernel tier resolver keeps the JAX package's vocabulary and fails
  loudly: tier "on" with CPU tensors, "interpret" and typos raise.
- The kernel module imports, and its CPU path runs, without nvcc; a tensor
  on a device with no kernel raises instead of falling back, for both
  kernel variants ("stream" and "grid"), and an unknown variant raises.
- The training slice: ShardedTrainStep needs CUDA unless given a device;
  what is not yet ported (float16 attention kernels, bf16 grid kernels, a
  mesh) raises instead of running something else, naming its ROADMAP
  item; bf16 reaches the stream kernels' bf16 entries; fused_optupdate
  routes the update through kernel #7's wrapper.
- The symbolic slice: DataParallelTrainStep, simple_bind / Executor and
  the NDArray constructors default to the card; the kernel #7 wrapper
  never falls back (an eligible CUDA leaf with no nvcc raises, a bad
  grad or slot raises before anything is built, any other device
  raises); what is not yet ported raises.
- The rtc slice: without CUDA, libcuda or NVRTC, ``CudaModule`` raises
  naming what is missing; a launch on the CPU, or with arguments that do
  not match the signature, raises before anything runs; a user op with
  no plain version raises on CPU tensors, and on an input that requires
  grad under grad mode (also inside a training graph); the Pallas names
  raise with guidance; importing the port loads neither libcuda, NVRTC
  nor triton.
- The Module slice: ``Module`` defaults to the card; what is not yet
  ported (a supervisor, a checkpoint manager, optimizer-state files,
  background checkpoints, distributed stores, more than one context,
  other optimizers, monitors, ``BucketingModule``, ``DevicePrefetchIter``,
  ``FeedForward``) raises naming its ROADMAP item; ``fit(kvstore=
  'tpu_sync')`` under ``MXNET_TPU_FUSED_OPTUPDATE=1`` updates through
  kernel #7's wrapper once a batch; the launcher ``run_script`` refuses a
  process that has imported jax, and in a fresh one resolves
  ``mxnet_tpu.*`` to the port's own module objects.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, rtc, run_script
from mxnet_tpu_torch.kernels import _build, _rtc_driver
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import opt_update as tou
from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerDecodeModel,
                                                init_transformer,
                                                transformer_forward)
from mxnet_tpu_torch.parallel import (DataParallelTrainStep,
                                      ShardedTrainStep, mesh_kernels,
                                      sharded_step)
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
    with pytest.raises(MXNetError, match="no kernel"):
        tfa.flash_attention_with_lse(q, q, q, offs, variant="grid")
    cpu_q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(MXNetError, match="unknown variant"):
        tfa.flash_attention_with_lse(cpu_q, cpu_q, cpu_q,
                                     torch.zeros(2, dtype=torch.int32),
                                     variant="blocked")


def test_train_step_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        ShardedTrainStep(lambda p, b: 0.0)
    with pytest.raises(MXNetError, match="CUDA"):
        ShardedTrainStep(lambda p, b: 0.0, device="cuda")
    assert ShardedTrainStep(lambda p, b: 0.0, device="cpu").device.type \
        == "cpu"


def test_train_step_raises_on_what_is_not_ported(monkeypatch):
    """... and fused_optupdate (the argument or the env knob) routes the
    update through kernel #7's wrapper with the JAX step's single-device
    arguments: rescale 1, no clip, wd 0 (the step added wd already)."""
    loss = lambda p, b: (p["w"] * b["x"]).sum()
    calls = []

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return tou.fused_update_step(*args, **kwargs)

    monkeypatch.setattr(sharded_step, "fused_update_step", spy)
    fused = ShardedTrainStep(loss, fused_optupdate=True, optimizer="sgd",
                             wd=0.1, device="cpu")
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    by_env = ShardedTrainStep(loss, optimizer="sgd", wd=0.1, device="cpu")
    monkeypatch.delenv("MXNET_TPU_FUSED_OPTUPDATE")
    plain = ShardedTrainStep(loss, optimizer="sgd", wd=0.1, device="cpu")
    finals = []
    for step in (fused, by_env, plain):
        step.init({"w": torch.ones(4)})
        step({"x": torch.arange(4.0)})
        finals.append(step.params["w"].detach())
    assert calls == [{}, {}], "fused steps must call the kernel wrapper"
    assert torch.equal(finals[0], finals[2]) and \
        torch.equal(finals[1], finals[2])
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
    with pytest.raises(MXNetError, match="no kernel"):
        tfa.flash_attention(q, q, q, causal=True, variant="grid")
    with pytest.raises(MXNetError, match="no kernel"):
        tfa._FlashAttention.apply(q, q, q, 0.5, True, (32, 32))
    with pytest.raises(MXNetError, match="unknown variant"):
        tfa.flash_attention(cpu_q, cpu_q, cpu_q, variant="blocked")
    with pytest.raises(MXNetError, match="needs CUDA"):
        tfa.flash_attention(cpu_q, cpu_q, cpu_q, use_pallas=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_wrappers_refuse_half_precision(dtype, monkeypatch):
    """The CUDA wrappers check before they build or launch anything: what
    is not yet ported raises "not yet ported (ROADMAP B2)", never a silent
    cast: float16 everywhere. bf16 reaches the bf16 entries of both
    variants (a recording stand-in for the launch here; one split, so no
    combine or reduce pass), a mixed dtype raises."""
    launched = []
    monkeypatch.setattr(tfa, "_launch",
                        lambda name, *a, device: launched.append(name))
    q = torch.zeros(1, 2, 4, 64, dtype=dtype)
    offs = torch.zeros(2, dtype=torch.int32)
    lse = torch.zeros(1, 2, 4)
    calls = (lambda: tfa._flash_fwd_cuda(q, q, q, 0.125, True),
             lambda: tfa._flash_fwd_offs_cuda(q, q, q, offs, 0.125, True),
             lambda: tfa._flash_bwd_cuda(q, q, q, offs, q, lse, lse, 0.125,
                                         True),
             lambda: tfa._flash_fwd_grid_cuda(q, q, q, None, 0.125, True, 32),
             lambda: tfa._flash_fwd_grid_cuda(q, q, q, offs, 0.125, True, 32),
             lambda: tfa._flash_bwd_grid_cuda(q, q, q, offs, q, lse, lse,
                                              0.125, True, (32, 32)))
    if dtype == torch.bfloat16:
        for call in calls:
            call()
        assert launched == ["mx_flash_fwd_bf16", "mx_flash_fwd_offs_bf16",
                            "mx_flash_bwd_dq_bf16", "mx_flash_bwd_dkv_bf16",
                            "mx_flash_fwd_grid_bf16",
                            "mx_flash_fwd_offs_grid_bf16",
                            "mx_flash_bwd_dq_grid_bf16",
                            "mx_flash_bwd_dkv_grid_bf16"]
        for call in (lambda: tfa._flash_fwd_cuda(q, q.float(), q, 0.125,
                                                 True),
                     lambda: tfa._flash_fwd_grid_cuda(q, q, q.float(), None,
                                                      0.125, True, 32)):
            with pytest.raises(MXNetError, match="the kernel takes"):
                call()
    else:
        for call in calls:
            with pytest.raises(MXNetError,
                               match=r"not yet ported \(ROADMAP B2\)"):
                call()
        assert not launched
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


# --------------------------------------------------- the symbolic slice ----


def _tiny_sym(mx=tmx):
    x = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(x, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def jmx_tiny_sym():
    return _tiny_sym(jmx)


def test_symbolic_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = _tiny_sym()
    with pytest.raises(MXNetError, match="CUDA"):
        DataParallelTrainStep(sym)
    with pytest.raises(MXNetError, match="CUDA"):
        sym.simple_bind(data=(2, 4))
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.Executor(sym, None, {})
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.zeros((2, 2))
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.array(np.zeros(2))
    assert DataParallelTrainStep(sym, device="cpu").device.type == "cpu"
    assert sym.simple_bind(tmx.cpu(), data=(2, 4)).arg_dict[
        "fc_weight"].context.type == "cpu"


def _leaf(device="cpu", n=1024, dtype=torch.float32):
    return torch.ones(n, dtype=dtype, device=device)


def test_opt_update_wrapper_never_falls_back(monkeypatch):
    # a kernel leaf on a device with no kernel raises
    p = _leaf("meta")
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        tou.fused_update_step("sgd", {"lr": 0.1}, {"w": p}, {"mom": None},
                              {"w": _leaf("meta")})
    # an eligible CUDA leaf with no nvcc raises instead of taking the
    # plain expression (CPU tensors stand in for CUDA ones here)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-toolkit"))
    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    params = {"w": _leaf(), "b": _leaf(n=10)}
    state = {"mom": {"w": _leaf(), "b": _leaf(n=10)}}
    before = tou.launches_sgd_mom
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tou.fused_update_step("sgd", {"lr": 0.1, "momentum": 0.9}, params,
                              state, {"w": _leaf(), "b": _leaf(n=10)})
    assert tou.launches_sgd_mom == before
    for t in (params["w"], params["b"], state["mom"]["b"]):
        assert torch.equal(t, torch.ones_like(t)), "nothing may be written"
    assert not _build._libs


@pytest.mark.parametrize("what,grad,slot", [
    ("float64 grad", _leaf(dtype=torch.float64), _leaf()),
    ("short slot", _leaf(), _leaf(n=896)),
    ("strided grad", torch.ones(2048)[::2], _leaf())])
def test_opt_update_wrapper_checks_before_building(monkeypatch, what, grad,
                                                   slot):
    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    with pytest.raises(MXNetError, match="must be a contiguous float32"):
        tou.fused_update_step("sgd", {"lr": 0.1, "momentum": 0.9},
                              {"w": _leaf()}, {"mom": {"w": slot}},
                              {"w": grad})
    assert not _build._libs, what


def test_opt_update_small_leaf_checked_before_building(monkeypatch):
    """A float32 leaf below the TPU kernel's size is the CUDA kernel's too:
    a strided grad raises before anything is built or written."""
    monkeypatch.setattr(tou, "_on_cuda", lambda t: True)
    params = {"w": _leaf(), "b": _leaf(n=10)}
    with pytest.raises(MXNetError, match="must be a contiguous float32"):
        tou.fused_update_step("sgd", {"lr": 0.1}, params, {"mom": None},
                              {"w": _leaf(), "b": torch.ones(20)[::2]})
    for t in params.values():
        assert torch.equal(t, torch.ones_like(t)), "nothing may be written"
    assert not _build._libs


def test_symbolic_slice_raises_on_what_is_not_ported(monkeypatch):
    sym = _tiny_sym()
    monkeypatch.setenv("MXNET_TPU_LINT", "1")
    with pytest.raises(MXNetError, match="ROADMAP A9"):
        DataParallelTrainStep(sym, device="cpu")
    monkeypatch.delenv("MXNET_TPU_LINT")
    for kw, match in ((dict(mesh=["cpu", "cpu"]), "ROADMAP A7"),
                      (dict(mesh=object()), "ROADMAP A7"),
                      (dict(zero=True), "ROADMAP A7"),
                      (dict(supervise=True), "ROADMAP A4")):
        with pytest.raises(MXNetError, match=match):
            DataParallelTrainStep(sym, device="cpu", **kw)
    # compute_dtype is ported, and the attention kernels of both variants
    # take bf16; float16 into them is not ported
    assert DataParallelTrainStep(sym, device="cpu",
                                 compute_dtype="bfloat16").compute_dtype \
        == torch.bfloat16
    q16 = torch.zeros(1, 2, 4, 64, dtype=torch.float16)
    for fn in (lambda q: tfa._flash_fwd_cuda(q, q, q, 0.125, True),
               lambda q: tfa._flash_fwd_grid_cuda(q, q, q, None, 0.125,
                                                  True, 32)):
        with pytest.raises(MXNetError, match=r"float16 .*ROADMAP B2"):
            fn(q16)
    qbf = q16.to(torch.bfloat16)
    offs = torch.zeros(2, dtype=torch.int32)
    lse = torch.zeros(1, 2, 4)
    assert tfa._check_qkv("grid", qbf, qbf, qbf, offs) == (1, 2, 4, 4, 64)
    assert tfa._check_bwd("grid", qbf, qbf, qbf, offs, qbf, lse, lse) \
        == (1, 2, 4, 4, 64)
    assert {tfa._ENTRIES[n][1] == tfa._ENTRIES[n[:-4] + "f32"][1]
            for n in tfa._ENTRIES if "_grid" in n and n.endswith("bf16")} \
        == {True}
    one = DataParallelTrainStep(sym, mesh=[torch.device("cpu")],
                                shard_update=True)
    assert one.device.type == "cpu"
    with pytest.raises(MXNetError, match="not yet ported"):
        one.warmup()
    with pytest.raises(MXNetError, match="not yet ported"):
        one.comm_plan()
    # infer_type is ported: float32 throughout, as the reference infers
    assert sym.infer_type() == jmx_tiny_sym().infer_type()
    with pytest.raises(MXNetError, match="not yet ported"):
        sym * 2
    with pytest.raises(AttributeError, match="not yet ported"):
        tmx.sym.Dropout
    with pytest.raises(MXNetError, match="not yet ported"):
        tmx.sym.load_json('{"nodes": [{"op": "null", "name": "x", '
                          '"inputs": []}, {"op": "Dropout", "name": "d", '
                          '"inputs": [[0, 0, 0]]}], "heads": [[1, 0, 0]]}')
    # reshape and indexed assignment are ported: the reference's behaviour
    exe = sym.simple_bind(tmx.cpu(), data=(2, 4))
    jexe = jmx_tiny_sym().simple_bind(jmx.cpu(), data=(2, 4))
    big, jbig = exe.reshape(data=(3, 4)), jexe.reshape(data=(3, 4))
    assert big.arg_dict["data"].shape == jbig.arg_dict["data"].shape
    assert [n for n, a in big.arg_dict.items() if a is exe.arg_dict[n]] == \
        [n for n, a in jbig.arg_dict.items() if a is jexe.arg_dict[n]]
    exe.arg_dict["data"][0] = 1.0
    jexe.arg_dict["data"][0] = 1.0
    np.testing.assert_array_equal(exe.arg_dict["data"].asnumpy(),
                                  jexe.arg_dict["data"].asnumpy())


# ------------------------------------------------------ the Module slice ----

def test_module_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.mod.Module(_tiny_sym())
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.mod.Module(_tiny_sym(), context=tmx.gpu(0))
    with pytest.raises(MXNetError, match="CUDA"):
        tmx.nd.ones((2,))
    mod = tmx.mod.Module(_tiny_sym(), context=tmx.cpu())
    assert mod._context == [torch.device("cpu")]


def test_module_computes_in_float32_unless_asked(monkeypatch):
    for allow in (None, "1"):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        if allow:
            monkeypatch.setenv("MXNET_ALLOW_TF32", allow)
        tmx.mod.Module(_tiny_sym(), context=tmx.cpu())
        assert torch.backends.cuda.matmul.allow_tf32 is bool(allow)
        assert torch.backends.cudnn.allow_tf32 is bool(allow)


def _bound_module(**fit_kw):
    rng = np.random.RandomState(0)
    it = tmx.io.NDArrayIter(rng.normal(size=(8, 4)).astype(np.float32),
                            rng.randint(0, 3, 8).astype(np.float32), 4)
    mod = tmx.mod.Module(_tiny_sym(), context=tmx.cpu())
    return mod, it


@pytest.mark.parametrize("what,item", [
    ("supervisor", "A8"), ("supervise_env", "A8"),
    ("checkpoint_manager", "A8"), ("save_optimizer_states", "A8"),
    ("background_checkpoint", "A8"), ("dist_kvstore", "A7"),
    ("async_kvstore", "A7"), ("two_contexts", "A7"),
    ("optimizer", "A2"), ("monitor", "A9"), ("bucketing", "A3"),
    ("prefetch_iter", "A4"), ("feedforward", "A3")])
def test_module_slice_raises_on_what_is_not_ported(what, item, monkeypatch):
    mod, it = _bound_module()
    fit = dict(num_epoch=1, optimizer_params={"learning_rate": 0.1})
    calls = {
        "supervisor": lambda: mod.fit(it, supervisor=object(), **fit),
        "supervise_env": lambda: mod.fit(it, **fit),
        "checkpoint_manager": lambda: mod.fit(it, checkpoint_manager=object(),
                                              **fit),
        "save_optimizer_states": lambda: (
            mod.fit(it, **fit), mod.save_optimizer_states("x.states")),
        "background_checkpoint": lambda: tmx.callback.do_checkpoint(
            "x", background=True),
        "dist_kvstore": lambda: tmx.kvstore.create("dist_sync"),
        "async_kvstore": lambda: tmx.kvstore.create("dist_async"),
        "two_contexts": lambda: tmx.mod.Module(
            _tiny_sym(), context=[tmx.cpu(), tmx.cpu()]),
        "optimizer": lambda: mod.fit(it, optimizer="nag", **fit),
        "monitor": lambda: mod.fit(it, monitor=object(), **fit),
        "bucketing": lambda: tmx.mod.BucketingModule,
        "prefetch_iter": lambda: tmx.io.DevicePrefetchIter,
        "feedforward": lambda: tmx.model.FeedForward,
    }
    if what == "supervise_env":
        monkeypatch.setenv("MXNET_TPU_TRAIN_SUPERVISE", "1")
    with pytest.raises(MXNetError, match="not yet ported \\(ROADMAP %s"
                       % item):
        calls[what]()


def test_module_tpu_sync_routes_through_kernel_7_wrapper(monkeypatch):
    """fit(kvstore='tpu_sync') builds the fused step on the module's
    device, and MXNET_TPU_FUSED_OPTUPDATE=1 sends its update through
    kernel #7's wrapper (on CPU tensors, its plain version)."""
    calls = []
    real = tou.fused_update_step
    monkeypatch.setattr("mxnet_tpu_torch.parallel.tpu_step."
                        "fused_update_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("MXNET_TPU_FUSED_OPTUPDATE", "1")
    mod, it = _bound_module()
    mod.fit(it, kvstore="tpu_sync", num_epoch=1,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused_step is not None and mod._fused_step.fused_optupdate
    assert mod._fused_step.device == torch.device("cpu")
    assert len(calls) == 2      # one per batch
    monkeypatch.delenv("MXNET_TPU_FUSED_OPTUPDATE")
    mod2, it = _bound_module()
    mod2.fit(it, kvstore="local", num_epoch=1)
    assert mod2._fused_step is None and len(calls) == 2


def test_launcher_refuses_a_process_with_jax():
    assert "jax" in sys.modules     # the tests' own process
    with pytest.raises(RuntimeError, match="already imported"):
        run_script.install()
    with pytest.raises(RuntimeError, match="already imported"):
        run_script.main(["script.py"])


def test_launcher_aliases_the_same_module_objects(tmp_path):
    """In a fresh process, mxnet_tpu and its submodules are the port's
    module objects, and jax is never imported."""
    script = tmp_path / "probe.py"
    script.write_text(
        "import sys\n"
        "import mxnet_tpu as mx\n"
        "from mxnet_tpu.models import resnet\n"
        "from mxnet_tpu.io import DataIter\n"
        "import mxnet_tpu.module.module as mm\n"
        "import mxnet_tpu_torch\n"
        "assert mx is mxnet_tpu_torch\n"
        "assert resnet is sys.modules['mxnet_tpu_torch.models.resnet']\n"
        "assert DataIter is mxnet_tpu_torch.io.DataIter\n"
        "assert mm is sys.modules['mxnet_tpu_torch.module.module']\n"
        "assert mx.models.get_symbol('mlp').name == 'softmax'\n"
        "assert not any(m == 'mxnet_tpu' or m.startswith('mxnet_tpu.')\n"
        "               for m in sys.modules if sys.modules[m].__name__\n"
        "               .startswith('mxnet_tpu.'))\n"
        "print('probe ok', sys.argv[1:])\n")
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.run_script", str(script),
         "a", "--b"], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "probe ok ['a', '--b']" in proc.stdout
    assert "run_script: jax not in sys.modules" in proc.stdout


# --------------------------------------------------------- the rtc slice ----

_AXPY = 'extern "C" __global__ void axpy(const float *x, float *y, float a, ' \
    'int n) { }'
_AXPY_SIG = "const float *x, float *y, float alpha, int n"


def _stand_in_kernel(monkeypatch, signature=_AXPY_SIG):
    """A kernel of a ``CudaModule`` compiled by a stand-in for NVRTC (this
    host has none): it holds no machine code and is never loaded."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(_rtc_driver, "driver", lambda: None)
        m.setattr(_rtc_driver, "compile_program",
                  lambda src, options, exports: (b"", {}, ""))
        return rtc.CudaModule(_AXPY).get_kernel("axpy", signature)


_op_ids = iter(range(10 ** 6))


def _user_op(monkeypatch, plain_fn):
    name = "rules_user_op_%d" % next(_op_ids)
    kernel = _stand_in_kernel(monkeypatch, "const float *x, float *y")
    nd_fn = rtc.register_cuda_op(name, kernel, lambda x: torch.empty_like(x),
                                 lambda x: ((1, 1, 1), (32, 1, 1)),
                                 plain_fn=plain_fn)
    return name, nd_fn, kernel


def test_cuda_module_names_what_is_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CudaModule needs CUDA"):
        rtc.CudaModule(_AXPY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(_rtc_driver._state, "driver", None)
    monkeypatch.setattr(_rtc_driver, "LIBCUDA",
                        str(tmp_path / "libcuda.so.1"))
    with pytest.raises(MXNetError, match="needs the CUDA driver"):
        rtc.CudaModule(_AXPY)
    monkeypatch.setattr(_rtc_driver, "driver", lambda: None)
    monkeypatch.setitem(_rtc_driver._state, "nvrtc", None)
    monkeypatch.setattr(_rtc_driver, "_nvrtc_dirs", lambda: [str(tmp_path)])
    with pytest.raises(MXNetError, match="needs NVRTC") as err:
        rtc.CudaModule(_AXPY)
    for name in _rtc_driver.NVRTC_NAMES:
        assert str(tmp_path / name) in str(err.value)


def test_nvrtc_search_order(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/toolkits/cuda-x")
    dirs = _rtc_driver._nvrtc_dirs()
    assert dirs[:2] == ["/toolkits/cuda-x/lib64", "/usr/local/cuda/lib64"]
    assert dirs[2].endswith(os.path.join("nvidia", "cuda_nvrtc", "lib"))
    monkeypatch.delenv("CUDA_HOME")
    assert _rtc_driver._nvrtc_dirs()[0] == "/usr/local/cuda/lib64"


def test_cuda_kernel_launch_refuses_the_cpu(monkeypatch):
    kernel = _stand_in_kernel(monkeypatch)
    x, y = torch.ones(4), torch.zeros(4)
    for ctx in (tmx.cpu(), "cpu", torch.device("meta")):
        with pytest.raises(MXNetError, match="only be launched on GPU"):
            kernel.launch([x, y, 1.0, 4], ctx, (1, 1, 1), (4, 1, 1))
    assert kernel.launches == 0 and torch.equal(y, torch.zeros(4))


_BAD_ARGS = {
    "dtype": (lambda x, y: [x.double(), y, 1.0, 4], MXNetError,
              "takes torch.float32"),
    "count": (lambda x, y: [x, y, 1.0], MXNetError, "expects 4 arguments"),
    "numpy": (lambda x, y: [x.numpy(), y, 1.0, 4], TypeError,
              "expected to be a NDArray"),
    "strided": (lambda x, y: [torch.ones(8)[::2], y, 1.0, 4], MXNetError,
                "not contiguous"),
    "device": (lambda x, y: [x.to("meta"), y, 1.0, 4], MXNetError,
               "not on ctx"),
    "tensor scalar": (lambda x, y: [x, y, torch.tensor(1.0), 4], TypeError,
                      "number"),
    "float for int": (lambda x, y: [x, y, 1.0, 4.5], TypeError, "integer"),
    "int range": (lambda x, y: [x, y, 1.0, 2 ** 31], MXNetError,
                  "does not fit"),
    "written grad": (lambda x, y: [x, y.requires_grad_(), 1.0, 4],
                     MXNetError, "requires grad"),
}


@pytest.mark.parametrize("what", sorted(_BAD_ARGS))
def test_cuda_kernel_checks_arguments_before_launching(monkeypatch, what):
    make, err, match = _BAD_ARGS[what]
    kernel = _stand_in_kernel(monkeypatch)
    with pytest.raises(err, match=match):
        kernel._pack(make(torch.ones(4), torch.zeros(4)), torch.device("cpu"))


def test_cuda_kernel_packs_arguments(monkeypatch):
    kernel = _stand_in_kernel(monkeypatch, "const float *x, float *y, "
                              "__half h, int64_t n, const double d")
    x, y = torch.ones(4), torch.zeros(4)
    packed, written = kernel._pack([tmx.nd.NDArray(x), y, 1.5,
                                    2 ** 40, 0.1], torch.device("cpu"))
    assert packed[0].value == x.data_ptr() and packed[1].value == \
        y.data_ptr()
    assert packed[2].value == int(np.float16(1.5).view(np.uint16))
    assert (packed[3].value, packed[4].value) == (2 ** 40, 0.1)
    assert len(written) == 1 and written[0] is y
    # a const pointer may require grad: the kernel only reads it
    kernel._pack([x.requires_grad_(), y, 1.0, 4, 0.0], torch.device("cpu"))


def test_user_op_without_plain_version_raises_on_cpu(monkeypatch):
    _, nd_fn, kernel = _user_op(monkeypatch, None)
    with pytest.raises(MXNetError, match="no plain_fn"):
        nd_fn(tmx.nd.array(np.ones(3), ctx=tmx.cpu()))
    assert kernel.launches == 0


def test_user_op_refuses_inputs_that_require_grad(monkeypatch):
    name, nd_fn, kernel = _user_op(monkeypatch, lambda x: torch.relu(x))
    x = torch.randn(6).requires_grad_(True)
    with pytest.raises(MXNetError, match="has no gradient"):
        nd_fn(x)
    with torch.no_grad():
        assert torch.equal(nd_fn(x)._data, torch.relu(x))
    tk = rtc.TritonModule().add_kernel("t", lambda *a: None,
                                       lambda v: torch.empty_like(v),
                                       plain_fn=lambda v: v * 2)
    with pytest.raises(MXNetError, match="has no gradient"):
        tk.launch([x], (1,))
    # a training graph that holds the op records, so it raises; an
    # inference pass of the same graph runs
    graph = {"nodes": [{"op": "null", "name": "data", "inputs": []},
                       {"op": name, "name": "u", "inputs": [[0, 0, 0]]}],
             "heads": [[1, 0, 0]]}
    sym = tmx.sym.load_json(json.dumps(graph))
    exe = sym.simple_bind(tmx.cpu(), data=(2, 3))
    exe.arg_dict["data"][:] = np.full((2, 3), -1.0, np.float32)
    with pytest.raises(MXNetError, match="has no gradient"):
        exe.forward(is_train=True)
    assert (exe.forward(is_train=False)[0].asnumpy() == 0).all()
    assert kernel.launches == 0


def test_triton_kernel_needs_triton_on_the_card():
    tk = rtc.TritonModule().add_kernel("t", lambda *a: None,
                                       lambda v: torch.empty_like(v))
    with pytest.raises(MXNetError, match="no plain_fn"):
        tk.launch([torch.ones(2)], (1,))
    # on the card: without triton installed, or with a kernel_fn that is
    # not a @triton.jit function, the launch raises
    with pytest.raises(MXNetError, match="triton"):
        tk._run_cuda(rtc._TritonLaunch((1,), {}), [torch.ones(2)],
                     torch.device("cuda", 0))
    assert tk.launches == 0


def test_user_op_puts_host_data_on_the_default_device(monkeypatch):
    """Host data given to a user op's ``nd`` function or to a Triton
    launch goes where ``NDArray`` puts it: the default device, float64 as
    float32. It never reaches ``plain_fn`` on the CPU while a card is
    there. This host has no card, so ``meta`` stands in for it: on meta
    tensors the op infers its outputs and launches nothing."""
    from mxnet_tpu_torch import context

    def plain_fn(x):
        raise AssertionError("host data reached plain_fn")

    _, nd_fn, kernel = _user_op(monkeypatch, plain_fn)
    tk = rtc.TritonModule().add_kernel("t", lambda *a: None,
                                       lambda v: torch.empty_like(v),
                                       plain_fn=plain_fn)
    monkeypatch.setattr(context, "default_device",
                        lambda: torch.device("meta"))
    for data in (np.ones(4, np.float32), np.ones(4), [1.0, 2.0, 3.0, 4.0]):
        for out in (nd_fn(data), tk.launch([data], (1,))):
            assert out.context == torch.device("meta")
            assert out.shape == (4,) and out._data.dtype == torch.float32
    assert kernel.launches == 0 and tk.launches == 0
    # without CUDA, host data raises instead of running on the CPU
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        nd_fn(np.ones(4, np.float32))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tk.launch([np.ones(4, np.float32)], (1,))


@pytest.mark.parametrize("name", ["PallasModule", "PallasKernel",
                                  "register_pallas_op"])
def test_pallas_names_raise_with_guidance(name):
    with pytest.raises(MXNetError,
                       match="CudaModule.*register_cuda_op.*TritonModule"):
        getattr(rtc, name)(lambda x: x, lambda x: x)


def test_import_loads_no_driver_nvrtc_or_triton():
    code = ("import sys, mxnet_tpu_torch\n"
            "from mxnet_tpu_torch.kernels import _rtc_driver as d\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert 'libcuda' not in maps and 'libnvrtc' not in maps\n"
            "assert d._state == {'driver': None, 'nvrtc': None, "
            "'nvrtc_path': None} and not d._contexts\n"
            "assert 'triton' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
