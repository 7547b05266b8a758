"""MobileNet with width multipliers 1.0/0.75/0.5/0.25 (parity: model_zoo/vision/mobilenet.py).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``, block for
block and prefix for prefix, so parameter names match the JAX
package's; ``pretrained=True`` raises (``model_store``)."""
from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm(scale=True))
    out.add(nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels)
    _add_conv(out, channels)


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2
                               + [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def _get(multiplier, **kwargs):
    pretrained = kwargs.pop("pretrained", False)
    ctx = kwargs.pop("ctx", None)
    root = kwargs.pop("root", "~/.mxnet/models")
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file("mobilenet%s" % multiplier,
                                       root=root), ctx=ctx)
    return net


def mobilenet1_0(**kwargs):
    return _get(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return _get(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return _get(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return _get(0.25, **kwargs)
