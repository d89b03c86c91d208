"""The gate a 16-bit attention kernel (#1-#6 on bf16 or float16 inputs)
is held to against its plain version in the same dtype, and a script that
reads it.

A 16-bit output keeps 8 (bf16) or 11 (float16) significant bits, so its
error is counted in ulps of its dtype, and ``row_ulps`` counts them
against each row's own scale. A row is one query's out or dq, or one
key's dk or dv (the last axis). Its scale is its largest |ref|, but at
least the dtype's row floor (``ROW_FLOOR``, ``F16_ROW_FLOOR``) times the
whole tensor's largest |ref|. The floor serves rows whose sum cancels to
rounding noise: dq of a causal first row, where ds = p (dp - deff) is
about 1e-7. Under a causal mask the late query rows of out and the late
keys of dk and dv are 30 to 1000 times smaller than the tensor's largest
value, since a late row averages hundreds of values. Counted against the
whole tensor's largest value, as ``tensor_ulps`` does, those rows could be
wrong and pass. A float16 ulp never goes below 2^-24, float16's least
subnormal.

Reading the gate::

    python -m mxnet_tpu_torch.kernels.bf16_gate [--dtype bfloat16|float16]
        [--seeds N] [--emulate]

holds every output of the six kernels against its plain version over N
seeds, through the C entries of the dtype: the stream kernels #5, #1 and
#2, and the split-KV ("grid") kernels #6, #3 and #4 with their combine and
reduce passes, on the card at the shapes of ``chip_smoke.py``'s
``bf16_kernel`` phase, or with ``--emulate`` through the host emulator
(``_emulate.py``) at the training sequence length on fewer heads. The
backward pairs get the plain forward's out and lse, so each kernel is read
on its own. It prints one JSON object: for each output, the largest
reading of both measures and the shape it came from.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BF16_ULPS", "ROW_FLOOR", "F16_ULPS", "F16_ROW_FLOOR", "GATES",
           "row_ulps", "tensor_ulps"]

#: the largest bf16 ``row_ulps`` a kernel output may read. Over 4 seeds at
#: the shapes of the ``bf16_kernel`` phase the sound kernels read at most
#: 2.0 on the card (dk at (4, 8, 4096, 128)) and 1.0 in the emulator;
#: kernels with a planted fault read 23 or more in the emulator (PERF.md,
#: §6). Each output rounds once on both sides, the forward rounds p
#: against each key tile's running max where the plain version takes the
#: row's max at once, and a long sum of dS q with one rounding of dS
#: flipped moves a row that cancels by more than one of its ulps.
BF16_ULPS = 3.0
#: the least scale of a bf16 row, as a fraction of the tensor's largest
#: |ref|
ROW_FLOOR = 2.0 ** -12
#: the largest float16 ``row_ulps``, set as the bf16 limit from readings
#: of the sound kernels and of planted faults (PERF.md, §6): the sound
#: kernels read at most 2.0 on the card (dk at (4, 8, 4096, 128)) and 1.0
#: in the emulator over 4 seeds; planted faults read 1688 or more in the
#: emulator
F16_ULPS = 3.0
#: the least scale of a float16 row. The rows the floor serves cancel to
#: float32 rounding noise, whose size does not depend on the dtype, so the
#: floor keeps bf16's floor ulp, 2^-19 of the tensor's largest |ref|: at
#: bf16's 2^-12 a float16 dq's causal first row (|dq| ~1e-6 of the
#: largest) read 4.25 ulps in the emulator, at 2^-9 1.0
F16_ROW_FLOOR = 2.0 ** -9
#: dtype -> (significand bits after the point, least normal exponent,
#: limit, row floor)
GATES = {torch.bfloat16: (7, -126, BF16_ULPS, ROW_FLOOR),
         torch.float16: (10, -14, F16_ULPS, F16_ROW_FLOOR)}


def _gate_dtype(got, ref, dtype):
    """``dtype``, else the 16-bit dtype of ``got`` or ``ref``, else bf16
    (callers that widened both to float32 first)."""
    if dtype is not None:
        return dtype
    for t in (got, ref):
        if t.dtype in GATES:
            return t.dtype
    return torch.bfloat16


def _ulp(scale, dtype=torch.bfloat16):
    """One ulp of ``dtype`` at ``scale`` (a tensor of positive
    magnitudes); below the least normal, the subnormals' spacing."""
    bits, e_min = GATES[dtype][:2]
    e = torch.clamp(torch.floor(torch.log2(scale)), min=e_min)
    return torch.exp2(e - bits)


def row_ulps(got, ref, dtype=None):
    """Largest |got - ref| of each row (the last axis) in ulps of ``dtype``
    (see ``_gate_dtype``) at that row's largest |ref|, floored at the
    dtype's row floor of the tensor's largest |ref|; the largest over the
    rows (inf where ``got`` holds a NaN). An all-zero ``ref`` must be met
    exactly."""
    dtype = _gate_dtype(got, ref, dtype)
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().nan_to_num(math.inf).amax(-1)   # NaN: inf
    top = ref.abs().max()
    if top.item() == 0:
        return math.inf if err.max().item() > 0 else 0.0
    scale = torch.maximum(ref.abs().amax(-1), top * GATES[dtype][3])
    return (err / _ulp(scale, dtype)).max().item()


def tensor_ulps(got, ref, dtype=None):
    """Largest |got - ref| in ulps of ``dtype`` at the whole tensor's
    largest |ref| (the measure ``row_ulps`` replaces; kept for the
    readings)."""
    dtype = _gate_dtype(got, ref, dtype)
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().nan_to_num(math.inf).max()   # NaN: inf
    top = ref.abs().max()
    if top.item() == 0:
        return math.inf if err.item() > 0 else 0.0
    return (err / _ulp(top, dtype)).item()


# --- readings -----------------------------------------------------------

def _outputs(call, q, k, v, offs, do, dlse, sm, causal, entry, width):
    """{output: (kernel's, plain version's)} of forward entry ``entry``
    ("fwd" for #5, "fwd_offs" for #1, "grid" for #6, "offs_grid" for #3)
    and of the backward pair of its family (#2, or #4 with ``width`` rows
    a split on both axes) on the plain forward's out and lse. The grid
    entries run their combine and reduce passes over float32 workspaces
    when there is more than one split. ``call(name, *args)`` runs a C
    entry; the entries are those of q's dtype."""
    from . import flash_attention as fa
    sfx = "_" + fa._DTYPES[q.dtype]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptr = lambda *ts: [t.data_ptr() for t in ts]   # noqa: E731
    pre = [] if entry in ("fwd", "grid") else [offs]
    if width is None:
        tail = (b * h, sq, sk, d, sm, int(causal))
        call("mx_flash_%s%s" % (entry, sfx), *ptr(q, k, v, *pre, out, lse),
             *tail)
        ref = (fa.flash_fwd_plain(q, k, v, sm, causal) if entry == "fwd"
               else fa.flash_fwd_offs_plain(q, k, v, offs, sm, causal))
    else:
        n = len(fa._splits(sk, width))
        nq = len(fa._splits(sq, width))
        work = lambda m, like: torch.empty(   # noqa: E731
            (m,) + tuple(like.shape), dtype=torch.float32, device=q.device)
        dst = (out, lse) if n == 1 else (work(n, q), work(n, lse))
        name = "mx_flash_fwd_%s" % entry
        call(name + sfx, *ptr(q, k, v, *pre, *dst), b * h, sq, sk, d,
             width, n, sm, int(causal))
        if n > 1:
            call(name + "_combine" + sfx, *ptr(*pre, *dst, out, lse), b * h,
                 sq, d, width, n, int(causal))
        ref = (fa.flash_fwd_grid_plain(q, k, v, sm, causal, width)
               if entry == "grid" else fa.flash_fwd_offs_grid_plain(
                   q, k, v, offs, sm, causal, width))
    deff = fa._deff(do, ref[0], dlse).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = ptr(q, k, v, offs, do, ref[1], deff)
    if width is None:
        call("mx_flash_bwd_dq" + sfx, *common, dq.data_ptr(), *tail)
        call("mx_flash_bwd_dkv" + sfx, *common, *ptr(dk, dv), *tail)
        want = fa.flash_bwd_offs_plain(q, k, v, offs, do, dlse, ref[0],
                                       ref[1], sm, causal)
    else:
        flags = (sm, int(causal))
        dq_dst = dq if n == 1 else work(n, q)
        call("mx_flash_bwd_dq_grid" + sfx, *common, dq_dst.data_ptr(), b * h,
             sq, sk, d, width, n, *flags)
        if n > 1:
            call("mx_flash_bwd_dq_grid_reduce" + sfx, *ptr(offs, dq_dst, dq),
                 b * h, sq, d, width, n, *flags)
        dkv_dst = (dk, dv) if nq == 1 else (work(nq, k), work(nq, v))
        call("mx_flash_bwd_dkv_grid" + sfx, *common, *ptr(*dkv_dst), b * h,
             sq, sk, d, width, nq, *flags)
        if nq > 1:
            call("mx_flash_bwd_dkv_grid_reduce" + sfx,
                 *ptr(offs, *dkv_dst, dk, dv), b * h, sq, sk, d, width, nq,
                 int(causal))
        want = fa.flash_bwd_offs_grid_plain(q, k, v, offs, do, dlse, ref[0],
                                            ref[1], sm, causal, width, width)
    kind = "" if width is None else "grid "
    return {entry + " out": (out, ref[0]), kind + "dq": (dq, want[0]),
            kind + "dk": (dk, want[1]), kind + "dv": (dv, want[2])}


def _cases(emulate):
    """(entry, q shape, keys, (q0, k0), causal, with an lse cotangent,
    split width or None)."""
    if emulate:
        return [("fwd", (1, 2, 512, 64), 512, (0, 0), True, False, None),
                ("fwd", (1, 2, 200, 32), 200, (0, 0), False, False, None),
                ("fwd_offs", (1, 2, 256, 64), 512, (256, 0), True, True,
                 None),
                ("fwd_offs", (1, 2, 64, 128), 512, (0, 256), True, True,
                 None),
                ("grid", (1, 2, 512, 64), 512, (0, 0), True, False, 128),
                ("offs_grid", (1, 2, 256, 64), 512, (256, 0), True, True,
                 96),
                ("offs_grid", (1, 2, 64, 128), 512, (0, 256), True, True,
                 64)]
    cases = []
    for d in (32, 64, 128):
        for c, offs in ((64, (0, 0)), (256, (0, 0)), (256, (256, 0)),
                        (64, (448, 0)), (64, (0, 256))):
            cases.append(("fwd_offs", (1, 8, c, d), 512, offs, True, True,
                          None))
    for shape, causal in (((8, 8, 512, 64), True), ((8, 8, 512, 32), True),
                          ((8, 8, 512, 128), True), ((2, 8, 200, 64), False),
                          ((4, 8, 4096, 128), True)):
        cases.append(("fwd", shape, shape[2], (0, 0), causal, False, None))
    for shape, causal, w in (((4, 8, 4096, 64), True, 512),
                             ((4, 8, 4096, 128), True, 512),
                             ((1, 4, 300, 32), True, 64),
                             ((2, 8, 1000, 64), False, 256)):
        cases.append(("grid", shape, shape[2], (0, 0), causal, False, w))
    for c, offs, w in ((1024, (2816, 0), 512), (256, (0, 2048), 512),
                       (1024, (0, 0), 32)):
        cases.append(("offs_grid", (1, 8, c, 64), 4096, offs, True, True,
                      w))
    return cases


def main(argv=None):
    import argparse
    import json
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--dtype", choices=("bfloat16", "float16"),
                        default="bfloat16")
    parser.add_argument("--emulate", action="store_true",
                        help="run the kernels' sources on the host CPU "
                             "through the emulator")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.emulate:
        from . import _emulate
        dev = torch.device("cpu")

        def call(name, *a):
            if _emulate.entry(name)(*a, None) != 0:
                raise RuntimeError("%s failed" % name)
    else:
        from . import flash_attention as fa
        dev = torch.device("cuda:0")

        def call(name, *a):
            fa._launch(name, *a, device=dev)
    worst = {}
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(1000 + seed)
        rand = lambda *s: torch.randn(*s, generator=gen).to(   # noqa: E731
            dev, dtype)
        for entry, (b, h, sq, d), sk, offs, causal, lse_cot, width in \
                _cases(args.emulate):
            q, k, v, do = (rand(b, h, sq, d), rand(b, h, sk, d),
                           rand(b, h, sk, d), rand(b, h, sq, d))
            dlse = (torch.randn(b, h, sq, generator=gen).to(dev)
                    if lse_cot else None)
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            what = "%s %s keys %d offs %s causal %s split %s" % (
                entry, (b, h, sq, d), sk, offs, causal, width)
            for name, (got, ref) in _outputs(call, q, k, v, o, do, dlse,
                                             1.0 / math.sqrt(d), causal,
                                             entry, width).items():
                w = worst.setdefault(name, {"row_ulps": 0.0,
                                            "tensor_ulps": 0.0})
                r, t = row_ulps(got, ref), tensor_ulps(got, ref)
                if r >= w["row_ulps"]:
                    w["row_ulps"], w["row_at"] = r, what
                if t >= w["tensor_ulps"]:
                    w["tensor_ulps"], w["tensor_at"] = t, what
    print(json.dumps({"dtype": args.dtype, "seeds": args.seeds,
                      "emulate": args.emulate, "limit": GATES[dtype][2],
                      "row_floor": GATES[dtype][3], "worst": worst},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
