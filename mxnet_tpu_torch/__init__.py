"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The same user surface as the JAX package (``mx.nd``, ``mx.sym``,
``mx.gluon``, ``Predictor``, ``serving.InferenceEngine``), built on
PyTorch: plain tensor work goes to PyTorch's operators (cuDNN/cuBLAS on
the card) and every TPU kernel on a ported path is a hand-written Hopper
kernel (``kernels/``). Entry points run on ``gpu(0)`` unless the caller
passes ``ctx=cpu()``. This package imports nothing of JAX or of
``mxnet_tpu``.

Ported so far: serving ResNet v1, training the causal-attention LM
through ``parallel.SPMDTrainer``, training ResNet v1 through
``gluon.block.make_pure_fn``, ``mx.mod.Module.fit`` and the Gluon loop
(``autograd.record``, ``gluon.loss``, ``gluon.Trainer``, ``hybridize``),
continuous-batching decode through ``decode.DecodeEngine``, and the
recurrent family (``gluon.rnn`` over the fused ``RNN`` op, the symbolic
cells of ``mx.rnn`` through ``mx.mod.BucketingModule``), and image
classification beyond ResNet (``mx.kvstore``, the ``fit.py`` recipe,
``gluon.data`` and the Gluon model zoo), each on one device, and the
instruments and controls around them (``mx.telemetry``, ``mx.faults``,
``mx.flight``, ``mx.profiler``, the autotuned serving plan), and
data-parallel training across contexts and worker processes (the
``dist*`` stores with 2-bit and fp16 compression, ``launch.py``,
``Module`` over several contexts, the dp ``SPMDTrainer``), and records
and images (``mx.recordio``, ``io.ImageRecordIter`` over the native
loader, ``mx.image``/``mx.img``), the convolutional recurrent cells
(``gluon.contrib.rnn``, ``mx.rnn``'s conv cells) and the runtime around
them (``mx.engine``, ``mx.storage``, ``mx.registry``, ``mx.libinfo``,
``mx.viz``, ``mx.test_utils``, ``mx.contrib``), and the C boundary (the
C API and the C predict API in ``kernels/_build/libmxnet.so``, built at
first use, and ``mx.rtc``'s NVRTC-compiled CUDA C); see ROADMAP.md.

A worker started by ``python -m mxnet_tpu_torch.launch`` joins its job
here, at import (``dist.init_from_env``), before anything else runs.
"""
from . import dist  # noqa: F401
dist.init_from_env()
from . import log  # noqa: F401,E402
from . import telemetry  # noqa: F401
from . import faults  # noqa: F401
from . import checkpoint  # noqa: F401
from .base import MXNetError, get_env  # noqa: F401
from .context import (Context, cpu, gpu, tpu, cpu_pinned,  # noqa: F401
                      current_context, num_gpus)
from . import config  # noqa: F401
from . import name, attribute, layout  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import ops  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import NDArray  # noqa: F401
from . import random  # noqa: F401
from . import random as rnd  # noqa: F401
from .random import seed  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import Symbol  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import executor  # noqa: F401
from .executor import Executor  # noqa: F401
from . import predictor  # noqa: F401
from . import serving  # noqa: F401
from . import gluon  # noqa: F401
from . import kernels  # noqa: F401
from . import weights  # noqa: F401
from . import optimizer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import imperative  # noqa: F401
from . import autograd  # noqa: F401
from . import metric  # noqa: F401
from . import io  # noqa: F401
from . import model  # noqa: F401
from . import gradient_compression  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from .kvstore import KVStore  # noqa: F401
from . import callback  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import parallel  # noqa: F401
from . import rnn  # noqa: F401
from . import decode  # noqa: F401
from . import flight  # noqa: F401
from . import compile_cache  # noqa: F401
from . import tuner  # noqa: F401
from . import profiler  # noqa: F401
from . import monitor  # noqa: F401
from . import monitor as mon  # noqa: F401
from .monitor import Monitor  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from . import executor_manager  # noqa: F401
from . import kvstore_server  # noqa: F401
from . import operator  # noqa: F401
from . import filesystem  # noqa: F401
from . import recordio  # noqa: F401
from . import resource  # noqa: F401
from . import image  # noqa: F401
from . import image as img  # noqa: F401
from .initializer import init_registry  # noqa: F401
from . import registry  # noqa: F401
from . import engine  # noqa: F401
from . import storage  # noqa: F401
from . import libinfo  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from . import test_utils  # noqa: F401
from . import contrib  # noqa: F401
from . import rtc  # noqa: F401

# mx.random's samplers (parity: mx.random.uniform is nd.random.uniform)
for _name in nd.random.__all__:
    setattr(random, _name, getattr(nd.random, _name))
del _name

# the env knobs of the flight recorder (MXNET_FLIGHT_DIR,
# MXNET_METRICS_INTERVAL_MS, MXNET_METRICS_PORT), as the JAX package
# adopts them at import; each defaults OFF
flight._maybe_autostart()
