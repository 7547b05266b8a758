"""Convolution and pooling gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: the 1-, 2- and 3-D
convolutions, their transposed forms over ``Deconvolution``, and the
max, average and global pools (``ceil_mode`` is
``pooling_convention="full"``). Under a channels-last layout a conv
weight is O+spatial+I, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ... import initializer as _init
from ... import layout as _layout
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, layout=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            ndim = len(kernel_size)
            self._channels = channels
            self._kernel = kernel_size
            self._strides = _tuple(strides, ndim)
            self._padding = _tuple(padding, ndim)
            self._dilation = _tuple(dilation, ndim)
            self._groups = groups
            self._act_type = activation
            self._layout = _layout.resolve(layout, ndim)
            self._channels_last = bool(self._layout) and \
                self._layout.endswith("C")
            cin = in_channels // groups if in_channels else 0
            wshape = ((channels,) + kernel_size + (cin,)
                      if self._channels_last
                      else (channels, cin) + kernel_size)
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,),
                    init=_init.create(bias_initializer))
            else:
                self.bias = None

    def _shape_hook(self, x, *args):
        if self._channels_last:
            self.weight._update_shape((self._channels,) + self._kernel +
                                      (x.shape[-1] // self._groups,))
        else:
            self.weight._update_shape(
                (self._channels, x.shape[1] // self._groups) + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._strides, pad=self._padding,
                            dilate=self._dilation, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None,
                            layout=self._layout)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


def _make_conv(name, ndim):
    class Conv(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     dilation=1, groups=1, layout=None, activation=None,
                     use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, prefix=None,
                     params=None):
            super().__init__(channels, _tuple(kernel_size, ndim), strides,
                             padding, dilation, groups, in_channels,
                             activation, use_bias, weight_initializer,
                             bias_initializer, layout=layout, prefix=prefix,
                             params=params)
    Conv.__name__ = name
    Conv.__qualname__ = name
    return Conv


Conv1D = _make_conv("Conv1D", 1)
Conv2D = _make_conv("Conv2D", 2)
Conv3D = _make_conv("Conv3D", 3)


class _ConvTranspose(_Conv):
    """Transposed convolution over the ``Deconvolution`` op (parity:
    mxnet_tpu/gluon/nn/conv_layers.py:30-127, its ``transposed``
    branch): weight (in_channels, channels/groups, *kernel),
    channels-first only."""

    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, in_channels, activation,
                 use_bias, weight_initializer, bias_initializer, layout,
                 prefix, params):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, 0, activation, use_bias, weight_initializer,
                         bias_initializer, layout=layout, prefix=prefix,
                         params=params)
        if self._channels_last:
            raise MXNetError("transposed conv supports channels-first "
                             "layouts only")
        self._output_padding = _tuple(output_padding, len(kernel_size))
        self.weight.shape = (in_channels, channels // groups) + kernel_size

    def _shape_hook(self, x, *args):
        self.weight._update_shape(
            (x.shape[1], self._channels // self._groups) + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Deconvolution(x, weight, bias, kernel=self._kernel,
                              stride=self._strides, pad=self._padding,
                              dilate=self._dilation,
                              adj=self._output_padding,
                              num_filter=self._channels,
                              num_group=self._groups, no_bias=bias is None)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


def _make_conv_transpose(name, ndim):
    class ConvTranspose(_ConvTranspose):
        def __init__(self, channels, kernel_size, strides=1, padding=0,
                     output_padding=0, dilation=1, groups=1, layout=None,
                     activation=None, use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, prefix=None,
                     params=None):
            super().__init__(channels, _tuple(kernel_size, ndim), strides,
                             padding, output_padding, dilation, groups,
                             in_channels, activation, use_bias,
                             weight_initializer, bias_initializer, layout,
                             prefix, params)
    ConvTranspose.__name__ = name
    ConvTranspose.__qualname__ = name
    return ConvTranspose


Conv1DTranspose = _make_conv_transpose("Conv1DTranspose", 1)
Conv2DTranspose = _make_conv_transpose("Conv2DTranspose", 2)
Conv3DTranspose = _make_conv_transpose("Conv3DTranspose", 3)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._global_pool = global_pool
        self._pool_type = pool_type
        self._ceil_mode = ceil_mode
        self._layout = _layout.resolve(layout, len(pool_size))

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(
            x, kernel=self._pool_size, stride=self._strides,
            pad=self._padding, pool_type=self._pool_type,
            global_pool=self._global_pool,
            pooling_convention="full" if self._ceil_mode else "valid",
            layout=self._layout)


def _make_pool(name, ndim, pool_type, global_pool=False):
    class Pool(_Pooling):
        def __init__(self, pool_size=2, strides=None, padding=0,
                     ceil_mode=False, layout=None, prefix=None, params=None):
            if global_pool:
                pool_size, strides, padding = (1,) * ndim, (1,) * ndim, \
                    (0,) * ndim
            else:
                pool_size = _tuple(pool_size, ndim)
                strides = _tuple(strides, ndim) if strides is not None \
                    else None
                padding = _tuple(padding, ndim)
            super().__init__(pool_size, strides, padding, ceil_mode,
                             global_pool, pool_type, layout=layout,
                             prefix=prefix, params=params)
    Pool.__name__ = name
    Pool.__qualname__ = name
    return Pool


MaxPool1D = _make_pool("MaxPool1D", 1, "max")
MaxPool2D = _make_pool("MaxPool2D", 2, "max")
MaxPool3D = _make_pool("MaxPool3D", 3, "max")
AvgPool1D = _make_pool("AvgPool1D", 1, "avg")
AvgPool2D = _make_pool("AvgPool2D", 2, "avg")
AvgPool3D = _make_pool("AvgPool3D", 3, "avg")
GlobalMaxPool1D = _make_pool("GlobalMaxPool1D", 1, "max", global_pool=True)
GlobalMaxPool2D = _make_pool("GlobalMaxPool2D", 2, "max", global_pool=True)
GlobalMaxPool3D = _make_pool("GlobalMaxPool3D", 3, "max", global_pool=True)
GlobalAvgPool1D = _make_pool("GlobalAvgPool1D", 1, "avg", global_pool=True)
GlobalAvgPool2D = _make_pool("GlobalAvgPool2D", 2, "avg", global_pool=True)
GlobalAvgPool3D = _make_pool("GlobalAvgPool3D", 3, "avg", global_pool=True)
