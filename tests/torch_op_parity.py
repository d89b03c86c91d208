"""The harness of the op-family parity tests (``test_torch_multibox.py``,
``test_torch_vision_ops.py``, ``test_torch_fork_ops.py``,
``test_torch_compat_ops.py``, ``test_torch_image_linalg_ops.py``).

A ``Case`` names one op call: the op, its numpy inputs, its attributes,
the inputs whose gradient is held (``grad``), training or inference
(``train``), the tolerance and the outputs that must match exactly
(``exact``: index outputs). ``reference(cases)`` runs every case of a
file through the ``mxnet_tpu`` op in one jitted program (the outputs, and
the gradient of the first output for one cotangent by ``jax.vjp``; the
``DIVIDING_OPS`` in a second);
``port(case, cot)`` runs the case through the port's
``mx.nd`` under ``autograd.record`` on the CPU and seeds the same
cotangent. ``check(case, want)`` holds the two to each other.
"""
import collections

import jax
import numpy as np

from mxnet_tpu.ops import find_op as jfind_op

import mxnet_tpu_torch as tmx

Case = collections.namedtuple(
    "Case", "id op arrays attrs grad train rtol atol exact cot_scale")


def case(id, op, arrays, attrs=None, grad=(), train=True, rtol=1e-5,
         atol=1e-6, exact=(), cot_scale=None):
    """``cot_scale``: the cotangent is this constant instead of a seeded
    normal draw (a loss scale's seed)."""
    return Case(id, op, [np.asarray(a) for a in arrays], dict(attrs or {}),
                tuple(grad), train, rtol, atol, tuple(exact), cot_scale)


def _jax_fn(c):
    jop = jfind_op(c.op)
    params = jop.make_params(dict(c.attrs))

    def f(arrays, *grads):
        ins = list(arrays)
        for i, g in zip(c.grad, grads):
            ins[i] = g
        # a drawing op gets a key; its cases fix the draw (min == max)
        rng = jax.random.PRNGKey(0) if jop.need_rng else None
        return jop.apply(params, ins, is_train=c.train, rng=rng)
    return f


def _run_cases(cases, all_arrays):
    """Each case's (outputs, first-output gradients, cotangent); the
    cotangent is a fixed pattern in [-1, 1], or ``cot_scale``
    everywhere."""
    res = []
    for c, arrays in zip(cases, all_arrays):
        f = _jax_fn(c)
        if not c.grad:
            res.append((f(arrays), (), None))
            continue

        def head(*g, f=f, arrays=arrays):
            outs = f(arrays, *g)
            return outs[0], outs
        out0, vjp, outs = jax.vjp(head, *[arrays[i] for i in c.grad],
                                  has_aux=True)
        if c.cot_scale is None:
            # sin of a scrambled ramp: varied values in [-1, 1] that cost
            # the compile nothing (a PRNG draw costs it seconds)
            n = max(out0.size, 1)
            ramp = jax.numpy.arange(n, dtype=jax.numpy.float32)
            cot = jax.numpy.sin(ramp * 2.3999632 + len(c.id))[:out0.size] \
                .reshape(out0.shape).astype(out0.dtype)
        else:
            cot = jax.numpy.full(out0.shape, c.cot_scale, out0.dtype)
        res.append((outs, vjp(cot), cot))
    return res


#: ops whose bins floor and ceil a quotient by a constant: their reference
#: program compiles without XLA's algebraic simplifier, which turns the
#: division into a product with the reciprocal and so moves a bin edge that
#: falls on an integer (ROADMAP §C); the reference's ``mx.nd`` runs op by
#: op and divides, as MXNet and the port do
DIVIDING_OPS = ("ROIPooling", "_contrib_PSROIPooling")


def _compiled(cases, options):
    arrays = [c.arrays for c in cases]
    if not cases:
        return []
    return jax.jit(lambda a: _run_cases(cases, a)).lower(arrays).compile(
        options)(arrays)


def reference(cases):
    """Every case's outputs, first-output gradients and cotangent (numpy)
    from one jitted program, traced once and compiled without XLA's
    backend optimisations (the same values; the compile is what a test
    pays for), the ``DIVIDING_OPS`` in a second one."""
    fast = {"xla_backend_optimization_level": 0}
    plain = [c for c in cases if c.op not in DIVIDING_OPS]
    dividing = [c for c in cases if c.op in DIVIDING_OPS]
    res = dict(zip([c.id for c in plain], _compiled(plain, fast)))
    res.update(zip([c.id for c in dividing], _compiled(
        dividing, dict(fast, xla_disable_hlo_passes="algsimp"))))
    return {c.id: ([np.asarray(o) for o in res[c.id][0]],
                   [np.asarray(g) for g in res[c.id][1]],
                   None if res[c.id][2] is None else np.asarray(res[c.id][2]))
            for c in cases}


def port(c, cot):
    """The case through the port's ``mx.nd``: (outputs, gradients)."""
    ctx = tmx.cpu()
    attrs = dict(c.attrs)
    if not c.arrays:
        attrs["ctx"] = ctx
    nds = [tmx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in c.arrays]
    for i in c.grad:
        nds[i].attach_grad()
    with tmx.autograd.record(train_mode=c.train):
        out = getattr(tmx.nd, c.op)(*nds, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    grads = []
    if c.grad:
        tmx.autograd.backward([outs[0]], [tmx.nd.array(cot, ctx=ctx,
                                                       dtype=cot.dtype)])
        grads = [nds[i].grad.asnumpy() for i in c.grad]
    return [o.asnumpy() for o in outs], grads


def check(c, want):
    """The port's outputs and gradients against the reference's: the
    ``exact`` outputs equal, the others within the case's tolerance."""
    j_outs, j_grads, cot = want
    t_outs, t_grads = port(c, cot)
    assert len(t_outs) == len(j_outs), c.id
    for k, (t, j) in enumerate(zip(t_outs, j_outs)):
        assert t.shape == j.shape, (c.id, k, t.shape, j.shape)
        if k in c.exact:
            np.testing.assert_array_equal(t, j, err_msg="%s out %d"
                                          % (c.id, k))
        else:
            np.testing.assert_allclose(t, j, rtol=c.rtol, atol=c.atol,
                                       err_msg="%s out %d" % (c.id, k))
    for k, (t, j) in enumerate(zip(t_grads, j_grads)):
        np.testing.assert_allclose(t, j, rtol=c.rtol, atol=c.atol,
                                   err_msg="%s grad %d" % (c.id, k))
    return t_outs


def rand(seed, shape, lo=-1.0, hi=1.0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)
