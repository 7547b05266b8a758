"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric`` with its
registry and ``create``, ``CompositeEvalMetric``, ``Accuracy``,
``TopKAccuracy``, ``F1``, ``Perplexity``, ``MAE``, ``MSE``, ``RMSE``,
``CrossEntropy``, ``NegativeLogLikelihood``, ``PearsonCorrelation``,
``Loss``, ``Torch``, ``Caffe``, ``CustomMetric`` and ``np``. As in the
JAX package, the hot metrics (accuracy, cross entropy, perplexity)
accumulate on the predictions' device (a running sum, fetched at
``get()``), so a training loop does not wait on the card once per
batch; the others, and numpy inputs, take the host path.
"""
from __future__ import annotations

import numpy as _numpy
import torch

from .base import MXNetError, registry_create, _KIND_REGISTRIES
from .ndarray.ndarray import NDArray
from . import telemetry

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register",
           "check_label_shapes"]

register = registry_create("metric")[0]
_REGISTRY = _KIND_REGISTRIES["metric"]


def create(metric, *args, **kwargs):
    """(parity: metric.create) a name, an instance, or a list of them."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key not in _REGISTRY:
        raise MXNetError("metric %r is not registered (known: %s)"
                         % (metric, sorted(_REGISTRY)))
    return _REGISTRY[key](*args, **kwargs)


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else _numpy.asarray(x)


def _on_device_of(pred, label):
    """The label tensor on the prediction's device (a host batch label
    against a card output)."""
    return label._data.to(pred._data.device)


def check_label_shapes(labels, preds, shape=False):
    if (not shape and len(labels) != len(preds)) or \
            (shape and labels.shape != preds.shape):
        raise MXNetError("Shape of labels %s does not match shape of "
                         "predictions %s" % (len(labels), len(preds)))


class EvalMetric:
    """Base metric (parity: metric.EvalMetric)."""

    # whether Module's fused step accumulates the metric as part of the
    # step (the JAX package's ``device_kernel``) instead of a separate
    # ``update_metric`` phase
    fused_in_step = False

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

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._dev_sum = None

    def _accum_device(self, scalar, n):
        """Add an fp32 device scalar to the running sum; no host sync."""
        self._dev_sum = scalar if self._dev_sum is None \
            else self._dev_sum + scalar
        self.num_inst += n

    def _flush_device(self):
        if self._dev_sum is not None:
            # THE metric synchronisation point: the only blocking fetch
            # the device accumulation ever issues
            telemetry.record_host_sync("metric_fetch")
            with telemetry.span("metric_fetch"):
                self.sum_metric += float(self._dev_sum)
            self._dev_sum = None

    def get(self):
        self._flush_device()
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


class CompositeEvalMetric(EvalMetric):
    """(parity: metric.CompositeEvalMetric)"""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, list):
                names.extend(name)
                values.extend(value)
            else:
                names.append(name)
                values.append(value)
        return (names, values)


@register
@register(name="acc")
class Accuracy(EvalMetric):
    # Module's fused step accumulates this metric as part of the step
    # (no ``metric_update`` span), as the JAX package's step program
    # runs Accuracy's device kernel in-program
    fused_in_step = True

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                p, l = pred._data, _on_device_of(pred, label)
                if p.ndim > l.ndim:
                    p = torch.argmax(p, dim=self.axis % p.ndim)
                p = p.to(torch.int32).reshape(-1)
                l = l.to(torch.int32).reshape(-1)
                if p.shape != l.shape:
                    raise MXNetError(
                        "Shape of labels %s does not match shape of "
                        "predictions %s" % (tuple(label.shape),
                                            tuple(pred.shape)))
                self._accum_device((p == l).sum().to(torch.float32),
                                   int(l.numel()))
                continue
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = _numpy.argmax(pred, axis=self.axis)
            pred = pred.astype(_numpy.int32).flatten()
            label = label.astype(_numpy.int32).flatten()
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
@register(name="top_k_accuracy")
@register(name="top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                p = pred._data
                if p.ndim != 2:
                    raise MXNetError("TopKAccuracy: predictions must be 2-D")
                l = _on_device_of(pred, label).to(torch.int64).reshape(-1, 1)
                topk = torch.topk(p, self.top_k, dim=1).indices
                self._accum_device((topk == l).sum().to(torch.float32),
                                   int(l.shape[0]))
                continue
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(_numpy.int32)
            topk = _numpy.argsort(pred, axis=1)[:, -self.top_k:]
            for j in range(self.top_k):
                self.sum_metric += float((topk[:, j] == label.flatten()).sum())
            self.num_inst += len(label)


@register
@register(name="ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                p = pred._data
                l = _on_device_of(pred, label).reshape(-1).to(torch.int64)
                if l.shape[0] != p.shape[0]:
                    raise MXNetError("CrossEntropy: %d labels for %d rows"
                                     % (l.shape[0], p.shape[0]))
                prob = torch.gather(p.float(), 1, l[:, None])[:, 0]
                self._accum_device(-torch.log(prob + self.eps).sum(),
                                   int(l.shape[0]))
                continue
            label = _as_numpy(label).ravel().astype(_numpy.int32)
            pred = _as_numpy(pred)
            prob = pred[_numpy.arange(label.shape[0]), label]
            self.sum_metric += float((-_numpy.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class Perplexity(EvalMetric):
    """(parity: metric.Perplexity) per update, over all its (label, pred)
    pairs: ``loss`` the summed ``-log(max(1e-10, p[label]))`` and ``num``
    the labels counted, an ``ignore_label`` position taking p = 1 and
    not counted; the running sum gains ``exp(loss / num) * num`` and the
    count ``num``, the reference's accumulation. Device predictions stay
    on the device (the sum in fp64 there); the count comes from the
    labels, which a Module's batches keep on the host."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        loss, num = None, 0
        for label, pred in zip(labels, preds):
            if isinstance(pred, NDArray):
                lab = label._data if isinstance(label, NDArray) \
                    else torch.from_numpy(_numpy.asarray(label))
                lab = lab.reshape(-1).to(torch.int64)
                p = pred._data.reshape(-1, pred.shape[-1])
                lab_dev = lab.to(p.device)
                probs = p.gather(1, lab_dev.clamp(0, p.shape[1] - 1)[:, None])
                probs = probs[:, 0]
                n = lab.numel()
                if self.ignore_label is not None:
                    ignore = lab_dev == int(self.ignore_label)
                    probs = torch.where(ignore, torch.ones_like(probs), probs)
                    n -= int((lab == int(self.ignore_label)).sum())
                part = -torch.log(torch.clamp(probs, min=1e-10)) \
                    .double().sum()
            else:
                lab = _as_numpy(label).astype(_numpy.int32).flatten()
                p = _as_numpy(pred)
                p = p.reshape(-1, p.shape[-1])
                probs = p[_numpy.arange(lab.size), lab]
                n = lab.size
                if self.ignore_label is not None:
                    ignore = lab == self.ignore_label
                    probs = _numpy.where(ignore, 1.0, probs)
                    n -= int(ignore.sum())
                part = float(-_numpy.log(_numpy.maximum(1e-10, probs)).sum())
            loss = part if loss is None else loss + part
            num += n
        if loss is None:
            return
        if isinstance(loss, torch.Tensor):
            self._accum_device(torch.exp(loss / max(num, 1)) * num, num)
        else:
            self.sum_metric += float(_numpy.exp(loss / max(num, 1))) * num
            self.num_inst += num


@register
class Loss(EvalMetric):
    """Mean of the raw outputs (parity: metric.Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            pred = _as_numpy(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


@register
class F1(EvalMetric):
    """Binary F1 of argmax predictions, averaged over updates (parity:
    mxnet_tpu/metric.py:341-363)."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(_numpy.int32)
            pred_label = _numpy.argmax(pred, axis=1)
            if len(_numpy.unique(label)) > 2:
                raise MXNetError("F1 currently only supports binary labels")
            tp = float(((pred_label == 1) & (label == 1)).sum())
            fp = float(((pred_label == 1) & (label == 0)).sum())
            fn = float(((pred_label == 0) & (label == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.0
            self.sum_metric += f1
            self.num_inst += 1


def _as_columns(label, pred):
    """Host copies, a 1-D label or prediction as one column."""
    label, pred = _as_numpy(label), _as_numpy(pred)
    if label.ndim == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.ndim == 1:
        pred = pred.reshape(pred.shape[0], 1)
    return label, pred


class _Regression(EvalMetric):
    """A mean over updates of ``_err(label - pred)`` (parity:
    mxnet_tpu/metric.py:398-452)."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _as_columns(label, pred)
            self.sum_metric += float(self._err(label - pred))
            self.num_inst += 1


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _err(d):
        return _numpy.abs(d).mean()


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _err(d):
        return (d ** 2).mean()


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    @staticmethod
    def _err(d):
        return _numpy.sqrt((d ** 2).mean())


@register
@register(name="nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """CrossEntropy under its own name (parity: mxnet_tpu/metric.py:482)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    update = CrossEntropy.update


@register
@register(name="pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson's r of each (pred, label) pair, averaged over updates."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            self.sum_metric += float(_numpy.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on host arrays, returning a
    value or ``(num_inst, sum_metric)`` (parity: metric.CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                num_inst, sum_metric = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """(parity: metric.np) a CustomMetric over a numpy ``feval``."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
