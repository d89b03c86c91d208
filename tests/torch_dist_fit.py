"""The two-context and ``dist_sync`` fits of ``test_torch_distributed.py``,
shared with its worker processes. It imports numpy only: a worker of the
launcher must not import the JAX package, whose import would join JAX's
own process group from the same environment.
"""
import numpy as np

N, BATCH = 96, 32
OPT = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
TWO_BIT = {"type": "2bit", "threshold": 0.5}


def _dataset():
    """Class-dependent blobs on noise (test_torch_module's dataset)."""
    rng = np.random.RandomState(6)
    label = rng.randint(0, 10, N)
    img = rng.uniform(0, 0.2, (N, 1, 28, 28))
    for i, c in enumerate(label):
        img[i, 0, (c // 5) * 12 + 2:(c // 5) * 12 + 12,
            (c % 5) * 5 + 2:(c % 5) * 5 + 6] += 0.7
    return img.astype(np.float32), label.astype(np.float32)


def _symbol(mx, network):
    with mx.name.NameManager():
        if network == "mlp":
            return mx.models.get_symbol("mlp", num_classes=10)
        # no bias before BatchNorm (as in ResNet): its gradient is 0 up
        # to rounding, so its value would be float32 noise
        x = mx.sym.Convolution(mx.sym.Variable("data"), kernel=(3, 3),
                               num_filter=4, no_bias=True, name="conv")
        x = mx.sym.BatchNorm(x, name="bn")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=10,
                                  name="fc")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _fit(mx, network, param_file, context, kvstore, compression=None,
         batch=BATCH, rows=None, record=None):
    """One epoch of SGD with momentum from ``param_file``; returns (the
    module, its final params and aux states as numpy)."""
    img, label = _dataset()
    if rows is not None:
        img, label = img[rows], label[rows]
    it = mx.io.NDArrayIter(img, label, batch)
    arg, aux = mx.model.load_params(param_file)
    kw = {"compression_params": compression} if compression else {}
    mod = mx.mod.Module(_symbol(mx, network), context=context, **kw)

    def batch_end(p):
        if record is not None:
            record.append(tuple(v for _, v in
                                p.eval_metric.get_name_value()))

    mod.fit(it, eval_metric=["acc", "crossentropy"], kvstore=kvstore,
            optimizer="sgd", optimizer_params=OPT, arg_params=arg,
            aux_params=aux, batch_end_callback=batch_end, num_epoch=1)
    a, x = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in {**a, **x}.items()}
