"""Evaluation metrics of the port: ``EvalMetric``, ``CompositeEvalMetric``,
``Accuracy``, ``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``,
``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``PearsonCorrelation``, ``Loss``, ``CustomMetric`` and ``create``
(reference: ``mxnet_tpu/metric.py`` L93-595).

``Accuracy`` and ``CrossEntropy`` compute each batch's increment as a
0-d tensor on the outputs' device, on the CPU and on the card alike.
``update`` folds it into the host sums at once; ``update_device`` (the
reference's in-graph path, ``_as_device``/``_device_fn``, L32-91), which
``Module.update_metric`` takes on the fused train path, keeps it pending
until ``get()``, so the fit loop does not wait for the card every batch.
Both fold with the same numpy-scalar arithmetic. The other metrics update
on the host (numpy), as the reference's ``update`` does. The plugin
metrics ``Torch`` and ``Caffe`` are not yet ported (ROADMAP A2):
``create`` raises on them.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import Registry
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np", "create", "metric_registry"]

metric_registry = Registry("metric", not_ported=("Torch", "Caffe"),
                           item="A2")


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def _as_device(x):
    """The tensor under ``x``, with no host transfer."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(_np.asarray(x))


def _acc_increment(pred, label, axis, do_argmax):
    if do_argmax:
        pred = pred.argmax(dim=axis)
    pred = pred.to(torch.int32).reshape(-1)
    label = label.to(pred.device, non_blocking=True).to(
        torch.int32).reshape(-1)
    return (pred == label).sum()


def _ce_increment(pred, label, eps):
    label = label.to(pred.device, non_blocking=True).reshape(-1).to(
        torch.int64)
    ok = (label >= 0) & (label < pred.shape[1])
    prob = pred[torch.arange(label.shape[0], device=pred.device),
                label.clamp(0, pred.shape[1] - 1)]
    # an out-of-range label poisons the sum, as the reference's in-graph
    # gather does
    prob = torch.where(ok, prob, torch.full_like(prob, float("nan")))
    return -(torch.log(prob + eps)).sum()


class EvalMetric:
    """reference: metric.py:93."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def update(self, labels, preds):
        raise NotImplementedError

    def update_device(self, labels, preds):
        """Append per-batch 0-d tensor increments to ``_dev_pending``
        without a host sync and return True; False (the default) means the
        caller must run ``update``."""
        return False

    def _fold(self, inc, n):
        # a bf16 increment (a bf16 step's outputs, as the reference sums
        # them) widens exactly: numpy has no bf16
        if inc.dtype == torch.bfloat16:
            inc = inc.float()
        self.sum_metric += inc.cpu().numpy()[()]
        self.num_inst += n

    def _drain_device_pending(self):
        pending = self.__dict__.get("_dev_pending")
        if not pending:
            return
        self._dev_pending = []
        for inc, n in pending:
            self._fold(inc, n)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._dev_pending = []

    def get(self):
        self._drain_device_pending()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def register(cls):
    metric_registry.register(cls)
    return cls


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return metric_registry.get(metric)(*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    """Fans every update out to child metrics and concatenates their
    results (reference: metric.py:186; a bad index raises)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError("Metric index %d is out of range 0 and %d"
                             % (index, len(self.metrics)))
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def update_device(self, labels, preds):
        for metric in self.metrics:
            if not metric.update_device(labels, preds):
                metric.update(labels, preds)
        return True

    def reset(self):
        # base __init__ calls reset() before self.metrics is assigned
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend([name] if isinstance(name, str) else name)
            values.extend([value] if _np.isscalar(value) else value)
        return names, values


class _TensorMetric(EvalMetric):
    """A metric whose batch increments come from ``_increments(labels,
    preds)`` as (0-d tensor, count) pairs."""

    def update(self, labels, preds):
        for inc, n in self._increments(labels, preds):
            self._fold(inc, n)

    def update_device(self, labels, preds):
        self._dev_pending.extend(self._increments(labels, preds))
        return True


@register
class Accuracy(_TensorMetric):
    """reference: metric.py:241."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _increments(self, labels, preds):
        check_label_shapes(labels, preds)
        out = []
        for label, pred in zip(labels, preds):
            p, l = _as_device(pred), _as_device(label)
            do_argmax = p.ndim > 1 and tuple(p.shape) != tuple(l.shape)
            n = (p.numel() // p.shape[self.axis] if do_argmax
                 else p.numel())
            check_label_shapes(l.reshape(-1), p.new_empty(n), shape=True)
            out.append((_acc_increment(p, l, self.axis, do_argmax), n))
        return out


acc = Accuracy
metric_registry.alias(Accuracy, "acc")


@register
class TopKAccuracy(EvalMetric):
    """reference: metric.py:288."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = _np.argsort(_as_np(pred_label).astype("float32"), axis=-1)
            label = _as_np(label).astype("int32")
            num_samples = pred.shape[0]
            num_dims = len(pred.shape)
            if num_dims == 1:
                self.sum_metric += (pred.flatten() == label.flatten()).sum()
            elif num_dims == 2:
                num_classes = pred.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred[:, num_classes - 1 - j].flatten()
                                        == label.flatten()).sum()
            self.num_inst += num_samples


metric_registry.alias(TopKAccuracy, "top_k_accuracy", "top_k_acc")


@register
class CrossEntropy(_TensorMetric):
    """reference: metric.py:481."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _increments(self, labels, preds):
        check_label_shapes(labels, preds)
        out = []
        for label, pred in zip(labels, preds):
            p, l = _as_device(pred), _as_device(label)
            if p.ndim != 2:
                raise ValueError("CrossEntropy: predictions of shape "
                                 "(batch, classes), got %s"
                                 % (tuple(p.shape),))
            check_label_shapes(l.reshape(-1), p[:, 0], shape=True)
            out.append((_ce_increment(p, l, self.eps), l.numel()))
        return out


class _BinaryClassificationMetrics:
    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred_label = _np.argmax(pred, axis=1) if pred.ndim > 1 \
            else (pred > 0.5)
        label = label.astype("int32").flatten()
        pred_label = pred_label.astype("int32").flatten()
        if len(_np.unique(label)) > 2:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        self.true_positives += ((pred_label == 1) & (label == 1)).sum()
        self.false_positives += ((pred_label == 1) & (label == 0)).sum()
        self.false_negatives += ((pred_label == 0) & (label == 1)).sum()
        self.true_negatives += ((pred_label == 0) & (label == 0)).sum()

    @property
    def precision(self):
        tp_fp = self.true_positives + self.false_positives
        return self.true_positives / tp_fp if tp_fp else 0.0

    @property
    def recall(self):
        tp_fn = self.true_positives + self.false_negatives
        return self.true_positives / tp_fn if tp_fn else 0.0

    @property
    def fscore(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def total_examples(self):
        return (self.true_positives + self.false_positives
                + self.false_negatives + self.true_negatives)

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.false_negatives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    """Binary F1, averaged over updates (``macro``) or over examples
    (reference metric.py:321)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_as_np(label), _as_np(pred))
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore \
                * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels; labels equal
    to ``ignore_label`` count for nothing (reference metric.py:390)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label)
            pred = _as_np(pred)
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape((-1, pred.shape[-1]))[
                _np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= _np.sum(ignore)
                probs = probs * (1 - ignore) + ignore
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += probs.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _as_columns(label, pred):
    label, pred = _as_np(label), _as_np(pred)
    if len(label.shape) == 1:
        label = label.reshape(label.shape[0], 1)
    if len(pred.shape) == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


class _RegressionMetric(EvalMetric):
    """Mean over updates of ``_error(label, pred)`` (MAE, MSE, RMSE)."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += self._error(*_as_columns(label, pred))
            self.num_inst += 1


@register
class MAE(_RegressionMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _error(label, pred):
        return _np.abs(label - pred).mean()


@register
class MSE(_RegressionMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _error(label, pred):
        return ((label - pred) ** 2.0).mean()


@register
class RMSE(_RegressionMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    @staticmethod
    def _error(label, pred):
        return _np.sqrt(((label - pred) ** 2.0).mean())


@register
class NegativeLogLikelihood(EvalMetric):
    """Sum of -log(p(label) + eps) over the examples (reference
    metric.py:525)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, (label.shape[0],
                                                    num_examples)
            prob = pred[_np.arange(num_examples, dtype=_np.int64),
                        _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += num_examples


metric_registry.alias(NegativeLogLikelihood, "nll_loss")


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            check_label_shapes(_as_np(label), _as_np(pred), shape=True)
            label = _as_np(label).ravel()
            pred = _as_np(pred).ravel()
            self.sum_metric += _np.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """The mean of a loss output the graph computes itself."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            self.sum_metric += _as_np(pred).sum()
            self.num_inst += pred.size


metric_registry.alias(Loss, "ce_loss")


@register
class CustomMetric(EvalMetric):
    """A metric from a numpy function ``feval(label, pred)`` (reference:
    metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference: metric.py np())."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
