"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Program/Block/Operator IR, JSON program format, layers, model
builders, executor and Predictor as the JAX package, with op lowerings
written in PyTorch and the TPU's Pallas kernels rewritten by hand for
Hopper (``csrc/``, built with nvcc at first use).  It serves
(``inference.Predictor``) and trains (``optimizer.AdamOptimizer``,
``clip``, ``contrib.mixed_precision``) BERT and Llama, generates with
Llama over a dense or paged KV cache (``serving.GenerationEngine``), and
serves both behind the dynamic-batching ``serving.ServingEngine`` and its
HTTP front end (``serving.serve``).  Programs run on
one device, the card (``cuda:0``) unless the caller passes
``CPUPlace()`` / ``device="cpu"``; on the card each feed signature's
step is captured once as a CUDA graph and replayed
(framework/executor.py).

The port imports neither jax nor ``paddle_tpu``.
"""
from . import framework  # noqa  (before ops: the executor imports the registry)
from . import ops  # noqa  (registers the operator library)
from .device import CPUPlace, CUDAPlace  # noqa
from .framework.core import (Program, Variable, Parameter, OpRole,  # noqa
                             default_main_program, default_startup_program,
                             program_guard, unique_name, reset_unique_name,
                             convert_dtype, grad_var_name)
from .framework.executor import (Executor, Scope, global_scope,  # noqa
                                 scope_guard, FetchHandle, AsyncRunResult)
from .flags import set_flags, get_flags  # noqa
from . import flags, monitor  # noqa
from .framework.layer_helper import ParamAttr  # noqa
from .framework import initializer  # noqa
from . import layers  # noqa
from .layers.tensor import data  # noqa
from . import io  # noqa
from . import inference  # noqa
from . import interop  # noqa
from . import errors  # noqa
from . import optimizer  # noqa
from . import clip  # noqa
from . import regularizer  # noqa
from . import contrib  # noqa
from . import fault  # noqa
from . import serving  # noqa
from .framework.backward import append_backward  # noqa

__version__ = "0.1.0"
