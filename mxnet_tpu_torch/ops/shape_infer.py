"""Parameter-shape inference for weight-bearing ops.

Counterpart of ``mxnet_tpu/ops/shape_infer.py`` (the reference's per-op
``FInferShape``): each hook ``(input_shapes, params) -> {input_index:
shape}`` fills the shapes of learnable inputs from the data shape.
Output shapes come from running the op on ``meta`` tensors.
"""
from __future__ import annotations

import numpy as np

from .common import as_tuple, channels_last
from .registry import get_op


def _fc(shapes, params):
    data = shapes[0]
    num_hidden = int(params.get("num_hidden", 0))
    in_units = int(np.prod(data[1:])) if params.get("flatten", True) \
        else data[-1]
    out = {1: (num_hidden, in_units)}
    if not params.get("no_bias", False):
        out[2] = (num_hidden,)
    return out


def _conv(shapes, params):
    data = shapes[0]
    kernel = as_tuple(params.get("kernel")) or ()
    num_filter = int(params.get("num_filter", 0))
    num_group = int(params.get("num_group", 1))
    if channels_last(params.get("layout"), len(kernel)):
        out = {1: (num_filter,) + kernel + (data[-1] // num_group,)}
    else:
        out = {1: (num_filter, data[1] // num_group) + kernel}
    if not params.get("no_bias", False):
        out[2] = (num_filter,)
    return out


def _deconv(shapes, params):
    """(parity: mxnet_tpu/ops/shape_infer.py:47) weight (C_in, F/g, *k)"""
    data = shapes[0]
    kernel = as_tuple(params.get("kernel")) or ()
    num_filter = int(params.get("num_filter", 0))
    out = {1: (data[1], num_filter // int(params.get("num_group", 1)))
           + kernel}
    if not params.get("no_bias", True):
        out[2] = (num_filter,)
    return out


def _instance_norm(shapes, params):
    c = shapes[0][1]
    return {1: (c,), 2: (c,)}


def _layer_norm(shapes, params):
    c = shapes[0][int(params.get("axis", -1)) % len(shapes[0])]
    return {1: (c,), 2: (c,)}


def _leaky_relu(shapes, params):
    if params.get("act_type", "leaky") == "prelu":
        return {1: (shapes[0][1],)}
    return {}


def _upsampling(shapes, params):
    if params.get("sample_type") == "bilinear":
        scale = int(params.get("scale", 1))
        kernel = 2 * scale - scale % 2
        return {1: (shapes[0][1], 1, kernel, kernel)}
    return {}


def _regression_output(shapes, params):
    return {1: tuple(shapes[0])}


def _bn(shapes, params):
    c = shapes[0][int(params.get("axis", 1)) % len(shapes[0])]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _bn_add_relu(shapes, params):
    c = shapes[0][int(params.get("axis", 1)) % len(shapes[0])]
    # input 1 is the residual (same shape as data); 2-5 are BN params
    return {1: tuple(shapes[0]), 2: (c,), 3: (c,), 4: (c,), 5: (c,)}


def _softmax_output(shapes, params):
    data = shapes[0]
    if params.get("multi_output", False):
        return {1: (data[0],) + tuple(data[2:])}
    return {1: (data[0],)}


def _embedding(shapes, params):
    return {1: (int(params.get("input_dim", 0)),
                int(params.get("output_dim", 0)))}


def install():
    get_op("SoftmaxOutput").param_shape_infer = _softmax_output
    get_op("FullyConnected").param_shape_infer = _fc
    get_op("Convolution").param_shape_infer = _conv
    get_op("BatchNorm").param_shape_infer = _bn
    get_op("BatchNorm_v1").param_shape_infer = _bn
    get_op("_contrib_BatchNormAddReLU").param_shape_infer = _bn_add_relu
    get_op("Embedding").param_shape_infer = _embedding
    get_op("Deconvolution").param_shape_infer = _deconv
    get_op("InstanceNorm").param_shape_infer = _instance_norm
    get_op("LayerNorm").param_shape_infer = _layer_norm
    get_op("LeakyReLU").param_shape_infer = _leaky_relu
    get_op("UpSampling").param_shape_infer = _upsampling
    for name in ("LinearRegressionOutput", "MAERegressionOutput",
                 "LogisticRegressionOutput"):
        get_op(name).param_shape_infer = _regression_output
