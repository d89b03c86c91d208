"""The gate a bf16 attention kernel (#1, #5 and #2 on bf16 inputs) is held
to against its plain bf16 version, and a script that reads it.

A bf16 output keeps 8 significant bits, so its error is counted in bf16
ulps, and ``row_ulps`` counts them against each row's own scale. A row is
one query's out or dq, or one key's dk or dv (the last axis). Its scale is
its largest |ref|, but at least ``ROW_FLOOR`` times the whole tensor's
largest |ref|. The floor serves rows whose sum cancels to rounding noise:
dq of a causal first row, where ds = p (dp - deff) is about 1e-7. Under a
causal mask the late query rows of out and the late keys of dk and dv are
30 to 1000 times smaller than the tensor's largest value, since a late row
averages hundreds of values. Counted against the whole tensor's largest
value, as ``tensor_ulps`` does, those rows could be wrong and pass.

Reading the gate::

    python -m mxnet_tpu_torch.kernels.bf16_gate [--seeds N] [--emulate]

holds every output of the three kernels against its plain version over N
seeds, through the C entries: on the card at the shapes of
``chip_smoke.py``'s ``bf16_kernel`` phase, or with ``--emulate`` through
the host emulator (``_emulate.py``) at the training sequence length on
fewer heads. The backward pair gets the plain forward's out and lse, so
each kernel is read on its own. It prints one JSON object: for each
output, the largest reading of both measures and the shape it came from.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BF16_ULPS", "ROW_FLOOR", "row_ulps", "tensor_ulps"]

#: the largest ``row_ulps`` a kernel output may read. Over 4 seeds at the
#: shapes of the ``bf16_kernel`` phase the sound kernels read at most 2.0
#: on the card (dk at (4, 8, 4096, 128)) and 1.0 in the emulator; kernels
#: with a planted fault read 23 or more in the emulator (PERF.md, §6).
#: Each output rounds once on both sides, the forward rounds p against
#: each key tile's running max where the plain version takes the row's
#: max at once, and a long sum of dS q with one rounding of dS flipped
#: moves a row that cancels by more than one of its ulps.
BF16_ULPS = 3.0
#: the least scale of a row, as a fraction of the tensor's largest |ref|
ROW_FLOOR = 2.0 ** -12


def _ulp(scale):
    """One bf16 ulp at ``scale`` (a tensor of positive magnitudes)."""
    return torch.exp2(torch.floor(torch.log2(scale)) - 7)


def row_ulps(got, ref):
    """Largest |got - ref| of each row (the last axis) in bf16 ulps of that
    row's largest |ref|, floored at ``ROW_FLOOR`` of the tensor's largest
    |ref|; the largest over the rows. An all-zero ``ref`` must be met
    exactly."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().amax(-1)
    top = ref.abs().max()
    if top.item() == 0:
        return math.inf if err.max().item() > 0 else 0.0
    scale = torch.maximum(ref.abs().amax(-1), top * ROW_FLOOR)
    return (err / _ulp(scale)).max().item()


def tensor_ulps(got, ref):
    """Largest |got - ref| in bf16 ulps of the whole tensor's largest |ref|
    (the measure ``row_ulps`` replaces; kept for the readings)."""
    got, ref = got.float(), ref.float()
    top = ref.abs().max()
    if top.item() == 0:
        return math.inf if (got - ref).abs().max().item() > 0 else 0.0
    return ((got - ref).abs().max() / _ulp(top)).item()


# --- readings -----------------------------------------------------------

def _outputs(call, q, k, v, offs, do, dlse, sm, causal, entry):
    """{output: (kernel's, plain version's)} of forward entry ``entry``
    ("fwd" for #5, "fwd_offs" for #1) and of the backward pair #2 on the
    plain forward's out and lse. ``call(name, *args)`` runs a C entry."""
    from . import flash_attention as fa
    b, h, sq, d = q.shape
    sk = k.shape[2]
    tail = (b * h, sq, sk, d, sm, int(causal))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptr = lambda *ts: [t.data_ptr() for t in ts]   # noqa: E731
    if entry == "fwd":
        call("mx_flash_fwd_bf16", *ptr(q, k, v, out, lse), *tail)
        ref = fa.flash_fwd_plain(q, k, v, sm, causal)
    else:
        call("mx_flash_fwd_offs_bf16", *ptr(q, k, v, offs, out, lse), *tail)
        ref = fa.flash_fwd_offs_plain(q, k, v, offs, sm, causal)
    deff = fa._deff(do, ref[0], dlse).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = ptr(q, k, v, offs, do, ref[1], deff)
    call("mx_flash_bwd_dq_bf16", *common, dq.data_ptr(), *tail)
    call("mx_flash_bwd_dkv_bf16", *common, *ptr(dk, dv), *tail)
    want = fa.flash_bwd_offs_plain(q, k, v, offs, do, dlse, ref[0], ref[1],
                                   sm, causal)
    return {entry + " out": (out, ref[0]), "dq": (dq, want[0]),
            "dk": (dk, want[1]), "dv": (dv, want[2])}


def _cases(emulate):
    """(entry, q shape, keys, (q0, k0), causal, with an lse cotangent)."""
    if emulate:
        return [("fwd", (1, 2, 512, 64), 512, (0, 0), True, False),
                ("fwd", (1, 2, 200, 32), 200, (0, 0), False, False),
                ("fwd_offs", (1, 2, 256, 64), 512, (256, 0), True, True),
                ("fwd_offs", (1, 2, 64, 128), 512, (0, 256), True, True)]
    cases = []
    for d in (32, 64, 128):
        for c, offs in ((64, (0, 0)), (256, (0, 0)), (256, (256, 0)),
                        (64, (448, 0)), (64, (0, 256))):
            cases.append(("fwd_offs", (1, 8, c, d), 512, offs, True, True))
    for shape, causal in (((8, 8, 512, 64), True), ((8, 8, 512, 32), True),
                          ((8, 8, 512, 128), True), ((2, 8, 200, 64), False),
                          ((4, 8, 4096, 128), True)):
        cases.append(("fwd", shape, shape[2], (0, 0), causal, False))
    return cases


def main(argv=None):
    import argparse
    import json
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--emulate", action="store_true",
                        help="run the kernels' sources on the host CPU "
                             "through the emulator")
    args = parser.parse_args(argv)
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
            dev, torch.bfloat16)
        for entry, (b, h, sq, d), sk, offs, causal, lse_cot in _cases(
                args.emulate):
            q, k, v, do = (rand(b, h, sq, d), rand(b, h, sk, d),
                           rand(b, h, sk, d), rand(b, h, sq, d))
            dlse = (torch.randn(b, h, sq, generator=gen).to(dev)
                    if lse_cot else None)
            o = torch.tensor(offs, dtype=torch.int32, device=dev)
            what = "%s %s keys %d offs %s causal %s" % (entry, (b, h, sq, d),
                                                        sk, offs, causal)
            for name, (got, ref) in _outputs(call, q, k, v, o, do, dlse,
                                             1.0 / math.sqrt(d), causal,
                                             entry).items():
                w = worst.setdefault(name, {"row_ulps": 0.0,
                                            "tensor_ulps": 0.0})
                r, t = row_ulps(got, ref), tensor_ulps(got, ref)
                if r >= w["row_ulps"]:
                    w["row_ulps"], w["row_at"] = r, what
                if t >= w["tensor_ulps"]:
                    w["tensor_ulps"], w["tensor_at"] = t, what
    print(json.dumps({"seeds": args.seeds, "emulate": args.emulate,
                      "limit": BF16_ULPS, "row_floor": ROW_FLOOR,
                      "worst": worst}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
