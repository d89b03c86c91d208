"""MLP symbol of the port: a copy of ``mxnet_tpu/models/mlp.py``
(reference: example/image-classification/symbols/mlp.py), the default
network of ``train_mnist.py``."""
from .. import symbol as mx_sym


def get_symbol(num_classes=10, **kwargs):
    data = mx_sym.Variable("data")
    data = mx_sym.Flatten(data)
    fc1 = mx_sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = mx_sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = mx_sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = mx_sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = mx_sym.FullyConnected(act2, name="fc3", num_hidden=num_classes)
    return mx_sym.SoftmaxOutput(fc3, name="softmax")
