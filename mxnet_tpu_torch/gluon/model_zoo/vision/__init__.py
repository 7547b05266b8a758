"""Vision model zoo (parity: python/mxnet/gluon/model_zoo/vision):
ResNet v1, AlexNet, VGG, SqueezeNet, DenseNet, Inception v3 and
MobileNet, and ``get_model`` by name."""
from . import resnet as _resnet
from . import alexnet as _alexnet
from . import vgg as _vgg
from . import squeezenet as _squeezenet
from . import densenet as _densenet
from . import inception as _inception
from . import mobilenet as _mobilenet

from .resnet import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403

from ....base import MXNetError


_models = {}
for _mod in (_resnet, _alexnet, _vgg, _squeezenet, _densenet, _inception,
             _mobilenet):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower() \
                and not _name.startswith("get_"):
            _models[_name] = _obj

# the reference's get_model keys use dots (model_store.py naming); python
# identifiers cannot, so both spellings are registered
for _ref, _fn in [("mobilenet1.0", "mobilenet1_0"),
                  ("mobilenet0.75", "mobilenet0_75"),
                  ("mobilenet0.5", "mobilenet0_5"),
                  ("mobilenet0.25", "mobilenet0_25"),
                  ("squeezenet1.0", "squeezenet1_0"),
                  ("squeezenet1.1", "squeezenet1_1"),
                  ("inceptionv3", "inception_v3")]:
    if _fn in _models:
        _models[_ref] = _models[_fn]


def get_model(name, **kwargs):
    """(parity: model_zoo.vision.get_model) a network by its zoo name;
    ``pretrained=True`` raises (no download)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError("model %r not in zoo (have: %s)"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
