"""Stateful decode serving: continuous batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serving/decode.py``, on PyTorch. The engine is
model-agnostic: it owns the paged KV pool (device tensors shaped
``(num_blocks, block_size) + kv_shape``), the block tables and continuous
batching, and calls a bucketed batch-1 *prefill* body per prompt-length
bucket plus exactly one fixed-shape batched *decode step* body, both
through :class:`~..compile.builder.ProgramBuilder` so that
``program_counts()`` stays ``(len(buckets), 1)`` while serving.

Between every step it retires finished sequences (EOS / max-new-tokens /
deadline) and admits waiting ones (highest priority, then earliest
deadline, then FIFO). Chunked prefill (``prefill_chunk``) runs a long
prompt as bucket-sized pieces with one decode step for the other active
sequences between pieces. An allocation the pool cannot cover sheds typed
(:class:`~.kvcache.CacheOverflow`).

The built-in bodies (:func:`tiny_lm_params`) are a deliberately tiny
single-layer attention LM; real models plug in through
``prefill_fn``/``step_fn`` — :class:`~..models.transformer.
TransformerDecodeModel` is the multi-layer transformer family.

Device contract: ``device=None`` means ``cuda:0`` and raises ``MXNetError``
when CUDA is missing. Host inputs of a call (tokens, offsets, tables)
travel to the device through pinned buffers, asynchronously; the only
host syncs are the two reads of sampled tokens (after a prompt's last
prefill piece, and after each step) — decode cannot proceed without them.

Observability: counters via ``profiler.record_decode_event``, latency
histograms ``decode.<name>.step`` / ``.ttft`` / ``.intertoken``, and the
fault site ``decode.step`` before every device dispatch.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as _np
import torch

from .. import profiler as _prof
from ..base import get_env
from ..compile.builder import ProgramBuilder, TensorSpec
from ..context import resolve_device
from ..resilience import faults as _faults
from .batcher import DeadlineExceeded
from .kvcache import PagedKVCache, CacheOverflow, NULL_BLOCK

__all__ = ["DecodeEngine", "DecodeStream", "tiny_lm_params",
           "DEFAULT_DECODE_BUCKETS"]

#: Default prompt-length buckets for the prefill program family.
DEFAULT_DECODE_BUCKETS = (16, 64)

# Additive attention mask for padded positions. exp(-1e30 - max) is
# exactly 0.0 in f32, so masked garbage can never perturb real rows —
# the bit-parity guarantee rides on this.
_MASKED = -1e30


def tiny_lm_params(vocab=32, dim=16, seed=0):
    """Deterministic parameters for the built-in single-layer LM.

    Keys: ``emb (V, D)``, ``w_k (D, D)``, ``w_v (D, D)``,
    ``w_out (D, V)`` — float32 numpy arrays from a seeded RandomState,
    the same values the JAX package's ``tiny_lm_params`` gives."""
    rng = _np.random.RandomState(seed)
    s = 1.0 / math.sqrt(dim)
    return {
        "emb": rng.standard_normal((vocab, dim)).astype(_np.float32),
        "w_k": (rng.standard_normal((dim, dim)) * s).astype(_np.float32),
        "w_v": (rng.standard_normal((dim, dim)) * s).astype(_np.float32),
        "w_out": (rng.standard_normal((dim, vocab)) * s).astype(_np.float32),
    }


def _lm_prefill(params, k_pages, v_pages, tokens, start, length, table):
    """Built-in prefill body (batch 1, bucketed prompt chunk).

    ``tokens (L,)`` bucket-padded prompt chunk; ``start ()`` global
    position of its first token; ``length ()`` real tokens in it; ``table
    (MB,)`` the sequence's block table padded with the null block (all
    int64 tensors). Writes K/V for positions ``start..start+length-1``
    in place (padding rows scatter into the null block), attends the
    chunk's last real token over ``pos < start + length``, returns
    ``(next_id, k_pages, v_pages)``."""
    emb, w_k, w_v, w_out = (params["emb"], params["w_k"],
                            params["w_v"], params["w_out"])
    bs = k_pages.shape[1]
    dim = emb.shape[1]
    mb = table.shape[0]
    x = emb[tokens]                                     # (L, D)
    idx = torch.arange(tokens.shape[0], device=tokens.device)
    pos = (start + idx).clamp(0, mb * bs - 1)
    blk = torch.where(idx < length, table[pos // bs], NULL_BLOCK)
    k_pages.index_put_((blk, pos % bs), x @ w_k)
    v_pages.index_put_((blk, pos % bs), x @ w_v)
    x_last = x.index_select(0, (length - 1).reshape(1))[0]   # (D,)
    ks = k_pages[table].reshape(mb * bs, dim)
    vs = v_pages[table].reshape(mb * bs, dim)
    tpos = torch.arange(mb * bs, device=tokens.device)
    scores = (ks @ x_last) * (1.0 / math.sqrt(dim))
    scores = torch.where(tpos < start + length, scores, _MASKED)
    ctx = torch.softmax(scores, dim=-1) @ vs
    return torch.argmax(ctx @ w_out), k_pages, v_pages


def _lm_step(params, k_pages, v_pages, token_ids, positions, tables, active):
    """Built-in decode-step body (fixed batch shape, one program total).

    ``token_ids (B,)`` last emitted token per row; ``positions (B,)``
    write position of that token; ``tables (B, MB)`` block tables
    (inactive rows all-null); ``active (B,)`` bool. Inactive rows scatter
    into the null block and their outputs are discarded on the host.
    Every per-row computation contracts only over that row's own gathered
    blocks, so batched decode is bit-identical to solo decode."""
    emb, w_k, w_v, w_out = (params["emb"], params["w_k"],
                            params["w_v"], params["w_out"])
    bs = k_pages.shape[1]
    dim = emb.shape[1]
    b, mb = tables.shape
    x = emb[token_ids]                                  # (B, D)
    blk = torch.gather(tables, 1, (positions // bs)[:, None])[:, 0]
    blk = torch.where(active, blk, NULL_BLOCK)
    k_pages.index_put_((blk, positions % bs), x @ w_k)
    v_pages.index_put_((blk, positions % bs), x @ w_v)
    ks = k_pages[tables].reshape(b, mb * bs, dim)       # (B, T, D)
    vs = v_pages[tables].reshape(b, mb * bs, dim)
    tpos = torch.arange(mb * bs, device=tables.device)[None, :]
    scores = torch.einsum("bd,btd->bt", x, ks) * (1.0 / math.sqrt(dim))
    scores = torch.where(tpos <= positions[:, None], scores, _MASKED)
    ctx = torch.einsum("bt,btd->bd", torch.softmax(scores, dim=-1), vs)
    return torch.argmax(ctx @ w_out, dim=-1), k_pages, v_pages


def _params_to(params, device):
    """Params pytree (dicts of numpy arrays or tensors) on ``device``."""
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return torch.as_tensor(params).to(device)


def _float_dtype(params):
    """The dtype of the first floating leaf of the params pytree; float32
    where there is none."""
    todo = [params]
    while todo:
        leaf = todo.pop(0)
        if isinstance(leaf, dict):
            todo.extend(leaf.values())
        elif leaf.is_floating_point():
            return leaf.dtype
    return torch.float32


def _to_device(arr, device):
    """Host numpy array -> tensor on ``device`` without a host sync: a
    pinned staging copy, then an asynchronous transfer (the caching host
    allocator keeps the staging buffer until the copy has run)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DecodeStream:
    """Handle for one decode request: tokens appear incrementally, the
    terminal outcome resolves exactly once.

    ``tokens`` grows as the engine emits. ``result_wait`` blocks for the
    terminal outcome and returns the full token list, raising the typed
    error on shed/failure (partial tokens stay readable on ``.tokens``).
    Iterating the stream yields tokens as they are produced.
    ``on_token(stream, seq_no, token)`` / ``on_done(stream)`` callbacks run
    on the engine loop thread — keep them cheap."""

    def __init__(self, rid, prompt, max_new_tokens, deadline, priority,
                 trace=None, on_token=None, on_done=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline        # absolute monotonic or None
        self.priority = priority
        self.trace = trace
        self.tokens = []
        self.error = None
        self.outcome = None             # "served" | "shed" | "failed"
        self._on_token = on_token
        self._on_done = on_done
        self._cond = threading.Condition()
        self._done_evt = threading.Event()
        self.submitted_t = time.monotonic()
        self.first_token_t = None
        self.last_token_t = None
        # positions with K/V on device; None while prefill is still in
        # flight — the step loop must not see a mid-prefill sequence
        self._cached = None

    def _emit(self, token):
        with self._cond:
            self.tokens.append(token)
            seq_no = len(self.tokens)
            self._cond.notify_all()
        if self._on_token is not None:
            self._on_token(self, seq_no, token)
        return seq_no

    def _resolve(self, error=None):
        with self._cond:
            if self._done_evt.is_set():
                return False
            self.error = error
            self.outcome = ("served" if error is None else
                            "shed" if isinstance(error, DeadlineExceeded)
                            else "failed")
            self._done_evt.set()
            self._cond.notify_all()
        if self._on_done is not None:
            self._on_done(self)
        return True

    def done(self):
        return self._done_evt.is_set()

    def result_wait(self, timeout=None):
        if not self._done_evt.wait(timeout):
            raise TimeoutError("decode stream %s still generating" % self.rid)
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    def __iter__(self):
        i = 0
        while True:
            with self._cond:
                while len(self.tokens) <= i and not self._done_evt.is_set():
                    self._cond.wait(0.1)
                fresh = self.tokens[i:]
                finished = self._done_evt.is_set()
                err = self.error
            for tok in fresh:
                yield tok
            i += len(fresh)
            if finished and i >= len(self.tokens):
                if err is not None:
                    raise err
                return


class _MISSING:  # sentinel: "kwarg not passed" (None is a valid value)
    pass


class DecodeEngine:
    """Continuous-batching decode engine over a paged KV cache.

    Parameters
    ----------
    params : dict of tensors or numpy arrays
        Model parameters, moved to ``device`` (see :func:`tiny_lm_params`
        for the built-in LM's keys; opaque to custom bodies).
    eos_id : int or None
        Token id that terminates a sequence (emitted, then retired).
    block_size / num_blocks : int
        KV pool geometry (``MXNET_SERVING_DECODE_BLOCK`` /
        ``MXNET_SERVING_DECODE_BLOCKS``). Block 0 is reserved.
    batch_size : int
        Decode slots — THE fixed step shape (``MXNET_SERVING_DECODE_BATCH``).
    max_seq_len : int
        Hard cap on prompt + generated per sequence; fixes the block-
        table width (``MXNET_SERVING_DECODE_MAX_SEQ``).
    prefill_buckets : tuple of int
        Prompt-length buckets (``MXNET_SERVING_DECODE_BUCKETS``,
        comma-separated). One prefill program per bucket.
    default_deadline_ms : float or None
        Deadline applied when ``submit`` passes none
        (``MXNET_SERVING_DECODE_DEADLINE_MS``; unset/0 = no deadline).
    default_max_new : int
        Token budget when ``submit`` passes none
        (``MXNET_SERVING_DECODE_MAX_NEW``).
    kv_shape : tuple of int or None
        Trailing page dims beyond ``(num_blocks, block_size)``; default
        ``(model_dim,)``. The transformer family uses
        ``(num_layers, d_model)``.
    prefill_chunk : int or None
        Chunked-prefill piece size
        (``MXNET_SERVING_DECODE_PREFILL_CHUNK``; 0 disables). Resolved
        DOWN to a prefill bucket so chunk calls reuse the family.
    device : torch.device, str or None
        Where params and pages live; None means ``cuda:0``.

    All env vars are read once here — never per step.
    """

    def __init__(self, params, *, name="decode", eos_id=None,
                 block_size=None, num_blocks=None, batch_size=None,
                 max_seq_len=None, prefill_buckets=None,
                 default_deadline_ms=_MISSING, default_max_new=None,
                 prefill_fn=None, step_fn=None, kv_shape=None,
                 prefill_chunk=None, device=None, warmup=True,
                 autostart=True):
        self.device = resolve_device(device)
        self.name = name
        self.eos_id = eos_id
        if block_size is None:
            block_size = get_env("MXNET_SERVING_DECODE_BLOCK", 16, int)
        if num_blocks is None:
            num_blocks = get_env("MXNET_SERVING_DECODE_BLOCKS", 64, int)
        if batch_size is None:
            batch_size = get_env("MXNET_SERVING_DECODE_BATCH", 4, int)
        if max_seq_len is None:
            max_seq_len = get_env("MXNET_SERVING_DECODE_MAX_SEQ", 256, int)
        if prefill_buckets is None:
            raw = get_env("MXNET_SERVING_DECODE_BUCKETS",
                          ",".join(str(b) for b in DEFAULT_DECODE_BUCKETS))
            prefill_buckets = tuple(sorted(
                int(t) for t in raw.split(",") if t.strip()))
        if default_deadline_ms is _MISSING:
            default_deadline_ms = get_env(
                "MXNET_SERVING_DECODE_DEADLINE_MS", None, float)
            if default_deadline_ms is not None and default_deadline_ms <= 0:
                default_deadline_ms = None
        if default_max_new is None:
            default_max_new = get_env("MXNET_SERVING_DECODE_MAX_NEW", 32, int)
        if prefill_chunk is None:
            prefill_chunk = get_env("MXNET_SERVING_DECODE_PREFILL_CHUNK",
                                    0, int)
        self.batch_size = int(batch_size)
        self.max_seq_len = int(max_seq_len)
        self.prefill_buckets = tuple(b for b in prefill_buckets
                                     if b <= self.max_seq_len) or (
                                         self.max_seq_len,)
        self.default_deadline_ms = default_deadline_ms
        self.default_max_new = int(default_max_new)
        # chunked prefill: resolve the requested chunk DOWN to a bucket so
        # chunk calls come from the existing prefill family and
        # program_count stays len(buckets) + 1. 0 disables chunking.
        cands = [b for b in self.prefill_buckets if b <= int(prefill_chunk)]
        self.prefill_chunk = cands[-1] if (int(prefill_chunk) > 0
                                           and cands) else 0

        self._kv = PagedKVCache(num_blocks, block_size)
        self._mb = self._kv.blocks_for(self.max_seq_len)  # table width
        if kv_shape is None:
            dim = int(params["emb"].shape[1]) if "emb" in params else int(
                next(iter(params.values())).shape[-1])
            kv_shape = (dim,)
        self._params = _params_to(params, self.device)
        # the pages take the params' floating dtype: float32 pages (the
        # JAX engine's only ones) for a float32 model, bf16 or float16
        # pages, half the bytes of every page gathered, for a 16-bit one
        self._k_pages = torch.zeros(
            (self._kv.num_blocks, self._kv.block_size)
            + tuple(int(d) for d in kv_shape),
            dtype=_float_dtype(self._params), device=self.device)
        self._v_pages = torch.zeros_like(self._k_pages)
        # the bodies update the pages in place and return them (the
        # analog of the JAX engine donating arguments 1 and 2)
        self._prefill_b = ProgramBuilder(
            prefill_fn or _lm_prefill, site="decode.prefill.%s" % name,
            donate_argnums=(1, 2))
        self._step_b = ProgramBuilder(
            step_fn or _lm_step, site="decode.step.%s" % name,
            donate_argnums=(1, 2))

        self._cv = threading.Condition()
        self._waiting = []              # DecodeStream, EDF-ordered at admit
        self._slots = [None] * self.batch_size   # _Seq state per row
        self._stop = False
        self._rid_ctr = 0
        self._counters = {"submitted": 0, "served": 0, "shed": 0,
                          "failed": 0, "tokens": 0, "prefills": 0,
                          "prefill_chunks": 0, "steps": 0, "cache_oom": 0}
        self._lat_step = "decode.%s.step" % name
        self._lat_ttft = "decode.%s.ttft" % name
        self._lat_tok = "decode.%s.intertoken" % name

        if warmup:
            self.warmup()
        self._thread = None
        if autostart:
            self.start()

    # ------------------------------------------------------------------
    # program family
    # ------------------------------------------------------------------
    def warmup(self):
        """Register the whole family ahead of time (one prefill per
        bucket + the decode step; serving adds no program after this),
        then run each body once on all-null block tables, so every write
        lands in the null block and no live state changes. The eager
        analog of the JAX engine's AOT compile: the first request no
        longer pays one-time device costs (kernel build and module load,
        library handles, allocator and pinned-pool growth)."""
        i64 = torch.int64
        pages = TensorSpec(tuple(self._k_pages.shape), self._k_pages.dtype)
        for bucket in self.prefill_buckets:
            self._prefill_b.aot_info(
                self._params, pages, pages, TensorSpec((bucket,), i64),
                TensorSpec((), i64), TensorSpec((), i64),
                TensorSpec((self._mb,), i64), mode="aot")
        b, mb = self.batch_size, self._mb
        self._step_b.aot_info(
            self._params, pages, pages, TensorSpec((b,), i64),
            TensorSpec((b,), i64), TensorSpec((b, mb), i64),
            TensorSpec((b,), torch.bool), mode="aot")
        dev = self.device
        null_table = _to_device(_np.zeros((mb,), _np.int64), dev)
        one = _to_device(_np.array(1, _np.int64), dev)
        zero = _to_device(_np.array(0, _np.int64), dev)
        for bucket in self.prefill_buckets:
            self._prefill_b(self._params, self._k_pages, self._v_pages,
                            _to_device(_np.zeros((bucket,), _np.int64), dev),
                            zero, one, null_table)
        zeros_b = _np.zeros((b,), _np.int64)
        self._step_b(self._params, self._k_pages, self._v_pages,
                     _to_device(zeros_b, dev), _to_device(zeros_b, dev),
                     _to_device(_np.zeros((b, mb), _np.int64), dev),
                     _to_device(_np.zeros((b,), _np.bool_), dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def program_counts(self):
        """(prefill_programs, step_programs) — len(prefill_buckets) and
        exactly 1, flat while serving."""
        return (self._prefill_b.program_count(), self._step_b.program_count())

    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return None

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, deadline_ms=_MISSING,
               priority=0, trace=None, on_token=None, on_done=None):
        """Queue a prompt for decode; returns a :class:`DecodeStream`.

        Raises ``ValueError`` synchronously (nothing counted) for
        prompts the engine can never serve: empty, longer than the
        largest prefill bucket, or leaving no room to generate."""
        prompt = [int(t) for t in _np.asarray(tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if self._bucket_for(len(prompt)) is None and not (
                self.prefill_chunk and len(prompt) < self.max_seq_len):
            raise ValueError(
                "prompt of %d tokens exceeds the largest prefill bucket "
                "(%d) and chunked prefill is disabled "
                "(MXNET_SERVING_DECODE_PREFILL_CHUNK)"
                % (len(prompt), self.prefill_buckets[-1]))
        if max_new_tokens is None:
            max_new_tokens = self.default_max_new
        max_new_tokens = min(int(max_new_tokens),
                             self.max_seq_len - len(prompt))
        if max_new_tokens < 1:
            raise ValueError("prompt of %d tokens leaves no room to "
                             "generate (max_seq_len=%d)"
                             % (len(prompt), self.max_seq_len))
        if deadline_ms is _MISSING:
            deadline_ms = self.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        with self._cv:
            if self._stop:
                raise RuntimeError("decode engine %s is stopped" % self.name)
            self._rid_ctr += 1
            stream = DecodeStream("%s-%d" % (self.name, self._rid_ctr),
                                  prompt, max_new_tokens, deadline, priority,
                                  trace=trace, on_token=on_token,
                                  on_done=on_done)
            stream._order = self._rid_ctr
            self._counters["submitted"] += 1
            self._waiting.append(stream)
            self._cv.notify_all()
        _prof.record_decode_event(submitted=1)
        return stream

    def generate(self, tokens, max_new_tokens=None, timeout=60.0, **kw):
        """Blocking convenience: submit and wait for the full output."""
        return self.submit(tokens, max_new_tokens, **kw).result_wait(timeout)

    # ------------------------------------------------------------------
    # loop
    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._loop, name="mx-decode-%s" % self.name, daemon=True)
        self._thread.start()

    def stop(self, timeout=10.0):
        """Stop the loop; unfinished work resolves failed (counted)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        leftovers = []
        with self._cv:
            leftovers.extend(self._waiting)
            self._waiting = []
            for i, seq in enumerate(self._slots):
                if seq is not None:
                    leftovers.append(seq)
                    self._slots[i] = None
        for s in leftovers:
            self._kv.free(s.rid)
            self._finish(s, RuntimeError("decode engine stopped"))

    def _finish(self, stream, error=None):
        """Resolve a stream exactly once + count the outcome."""
        if not stream._resolve(error):
            return
        key = stream.outcome
        with self._cv:
            self._counters[key] += 1
            if isinstance(error, CacheOverflow):
                self._counters["cache_oom"] += 1
        _prof.record_decode_event(
            **({key: 1, "cache_oom": 1} if isinstance(error, CacheOverflow)
               else {key: 1}))

    def _loop(self):
        from ..resilience.watchdog import watchdog as _watchdog
        hb = _watchdog().register("mx-decode-%s" % self.name,
                                  thread=threading.current_thread())
        try:
            if self.device.type == "cuda":
                # the loop thread's current device is the engine's
                torch.cuda.set_device(self.device)
            while True:
                with self._cv:
                    while (not self._stop and not self._waiting
                           and not any(s is not None for s in self._slots)):
                        hb.idle()
                        self._cv.wait(0.05)
                    if self._stop:
                        return
                    hb.beat()
                    sheds, rejects, admitted = self._form_batch_locked()
                for s in sheds:
                    self._finish(s, s._shed_err)
                for s in rejects:
                    self._finish(s, s._shed_err)
                for s in admitted:
                    self._prefill_one(s)
                self._decode_step()
        finally:
            hb.close()

    def _form_batch_locked(self):
        """The formation pass (EDF): shed expired waiters, reject
        never-fit prompts, admit into free slots while their prompts fit
        the pool. Runs under ``_cv`` — host bookkeeping only."""
        now = time.monotonic()
        sheds, rejects = [], []
        keep = []
        for s in self._waiting:
            if s.deadline is not None and now > s.deadline:
                s._shed_err = DeadlineExceeded(
                    "decode %s: deadline expired before admission" % s.rid)
                sheds.append(s)
            elif self._kv.blocks_for(len(s.prompt) + 1) \
                    > self._kv.capacity_blocks:
                s._shed_err = CacheOverflow(
                    "decode %s: prompt of %d tokens can never fit a pool "
                    "of %d blocks" % (s.rid, len(s.prompt),
                                      self._kv.capacity_blocks))
                rejects.append(s)
            else:
                keep.append(s)
        # highest priority first, then earliest deadline, then arrival
        keep.sort(key=lambda s: (-s.priority,
                                 s.deadline if s.deadline is not None
                                 else float("inf"), s._order))
        admitted = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        still_waiting = []
        for s in keep:
            if free and self._kv.can_fit(len(s.prompt)):
                self._kv.allocate(s.rid, len(s.prompt))
                s._slot = free.pop(0)
                self._slots[s._slot] = s
                admitted.append(s)
            else:
                still_waiting.append(s)
        self._waiting = still_waiting
        return sheds, rejects, admitted

    def _evict(self, stream, error):
        """Drop an ACTIVE sequence: free its blocks, vacate its slot,
        resolve the outcome."""
        self._kv.free(stream.rid)
        self._slots[stream._slot] = None
        self._finish(stream, error)

    def _prefill_one(self, stream):
        """Run the bucketed prefill call(s) for one admitted sequence and
        emit its first token (device calls — outside ``_cv``).

        Chunked prefill: when ``prefill_chunk`` is set and the prompt is
        longer, the prompt runs as chunk-bucket-sized pieces through the
        same family, and one continuous-batching step runs for the other
        active sequences between pieces. The sequence stays invisible to
        the step loop until its last piece lands (``_cached`` is None),
        and per-chunk deadline checks shed typed mid-prefill."""
        prompt = stream.prompt
        chunk = self.prefill_chunk
        if chunk and len(prompt) > chunk:
            pieces = [prompt[i:i + chunk]
                      for i in range(0, len(prompt), chunk)]
        else:
            pieces = [prompt]
        table = _np.zeros((self._mb,), _np.int64)
        own = self._kv.table(stream.rid)
        table[:len(own)] = own
        table_d = _to_device(table, self.device)
        start = 0
        tok = None
        for pi, piece in enumerate(pieces):
            last = pi == len(pieces) - 1
            if pi and stream.deadline is not None \
                    and time.monotonic() > stream.deadline:
                self._evict(stream, DeadlineExceeded(
                    "decode %s: deadline exceeded mid-prefill after %d of "
                    "%d prompt tokens" % (stream.rid, start, len(prompt))))
                return
            bucket = self._bucket_for(len(piece))
            toks = _np.zeros((bucket,), _np.int64)
            toks[:len(piece)] = piece
            try:
                # inside the try, so an injected fault takes the path of a
                # failed dispatch (the JAX engine fires it outside, where
                # a raise kills the loop thread)
                _faults.fault_point("decode.step", model=self.name,
                                    kind="prefill", rid=stream.rid)
                next_id, self._k_pages, self._v_pages = self._prefill_b(
                    self._params, self._k_pages, self._v_pages,
                    _to_device(toks, self.device),
                    _to_device(_np.array(start, _np.int64), self.device),
                    _to_device(_np.array(len(piece), _np.int64),
                               self.device), table_d)
                if last:
                    # host sync: the sampled token feeds the next step and
                    # the reply stream
                    tok = int(next_id.item())
            except Exception as e:
                self._evict(stream, e if isinstance(e, DeadlineExceeded)
                            else RuntimeError(
                                "decode prefill failed: %s" % e))
                return
            start += len(piece)
            if not last:
                self._decode_step()
        now = time.monotonic()
        stream.first_token_t = stream.last_token_t = now
        stream._cached = len(prompt)    # positions 0..len-1 hold K/V
        _prof.record_latency(self._lat_ttft,
                             int((now - stream.submitted_t) * 1e9))
        with self._cv:
            self._counters["prefills"] += 1
            self._counters["tokens"] += 1
            if len(pieces) > 1:
                self._counters["prefill_chunks"] += len(pieces)
        _prof.record_decode_event(prefills=1, tokens=1)
        stream._emit(tok)
        self._maybe_retire(stream, tok)

    def _maybe_retire(self, stream, last_tok):
        """Retire on EOS or token budget; returns True when retired."""
        if ((self.eos_id is not None and last_tok == self.eos_id)
                or len(stream.tokens) >= stream.max_new_tokens):
            self._kv.free(stream.rid)
            self._slots[stream._slot] = None
            self._finish(stream, None)
            return True
        return False

    def _decode_step(self):
        """One continuous-batching iteration over the active slots:
        per-token deadline enforcement, cache growth (typed shed on
        overflow), one fixed-shape step call, distribution."""
        now = time.monotonic()
        # _cached is None while a sequence's prefill is still in flight
        # (chunked prefill steps the loop between pieces) — such rows
        # must be invisible here: no deadline eviction (the prefill loop
        # owns it), no growth, no step slot.
        for seq in [s for s in self._slots
                    if s is not None and s._cached is not None]:
            if seq.deadline is not None and now > seq.deadline:
                self._evict(seq, DeadlineExceeded(
                    "decode %s: deadline exceeded after %d tokens"
                    % (seq.rid, len(seq.tokens))))
        for seq in [s for s in self._slots
                    if s is not None and s._cached is not None]:
            try:
                # room for the token this step writes at position _cached
                self._kv.extend(seq.rid, 1)
            except CacheOverflow as e:
                self._evict(seq, e)
        active = [s for s in self._slots
                  if s is not None and s._cached is not None]
        if not active:
            return
        b, mb = self.batch_size, self._mb
        token_ids = _np.zeros((b,), _np.int64)
        positions = _np.zeros((b,), _np.int64)
        tables = _np.zeros((b, mb), _np.int64)
        mask = _np.zeros((b,), _np.bool_)
        for seq in active:
            i = seq._slot
            token_ids[i] = seq.tokens[-1]
            positions[i] = seq._cached
            own = self._kv.table(seq.rid)
            tables[i, :len(own)] = own
            mask[i] = True
        t0 = time.monotonic()
        dev = self.device
        try:
            _faults.fault_point("decode.step", model=self.name, kind="step",
                                batch=len(active))
            next_ids, self._k_pages, self._v_pages = self._step_b(
                self._params, self._k_pages, self._v_pages,
                _to_device(token_ids, dev), _to_device(positions, dev),
                _to_device(tables, dev), _to_device(mask, dev))
            # host sync: the sampled tokens feed the next step and the
            # reply streams
            ids = next_ids.cpu().numpy()
        except Exception as e:
            # step state is unknown after a failed dispatch: fail the
            # whole active set (chaos tests drive this via decode.step)
            err = e if isinstance(e, DeadlineExceeded) else RuntimeError(
                "decode step failed: %s" % e)
            for seq in active:
                self._evict(seq, err)
            return
        now = time.monotonic()
        _prof.record_latency(self._lat_step, int((now - t0) * 1e9))
        with self._cv:
            self._counters["steps"] += 1
            self._counters["tokens"] += len(active)
        _prof.record_decode_event(steps=1, tokens=len(active),
                                  slot_steps=len(active),
                                  slot_capacity=self.batch_size)
        for seq in active:
            tok = int(ids[seq._slot])
            seq._cached += 1
            if seq.last_token_t is not None:
                _prof.record_latency(
                    self._lat_tok, int((now - seq.last_token_t) * 1e9))
            seq.last_token_t = now
            seq._emit(tok)
            self._maybe_retire(seq, tok)

    # ------------------------------------------------------------------
    def stats(self):
        """Counters + cache occupancy + program family sizes."""
        with self._cv:
            out = dict(self._counters)
            out["waiting"] = len(self._waiting)
            out["active"] = sum(1 for s in self._slots if s is not None)
        out["kv"] = self._kv.stats()
        pf, st = self.program_counts()
        out["programs"] = {"prefill": pf, "step": st}
        sites = _prof.compile_counters()["sites"]
        out["compile"] = {
            "prefill": sites.get("decode.prefill.%s" % self.name, {}),
            "step": sites.get("decode.step.%s" % self.name, {})}
        return out
