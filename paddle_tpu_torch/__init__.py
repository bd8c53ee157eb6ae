"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The same Program/Block/Operator IR, JSON program format, layers, model
builders, executor and Predictor as the JAX package, with op lowerings
written in PyTorch and the TPU's Pallas kernels rewritten by hand for
Hopper (``csrc/``, built with nvcc at first use).  It serves
(``inference.Predictor``) and trains (``optimizer``'s SGD, Adam, AdamW
and ``RecomputeOptimizer``, ``clip``, ``regularizer``, the LR decays,
``contrib.mixed_precision``) BERT and Llama, generates with
Llama over a dense or paged KV cache (``serving.GenerationEngine``), and
serves both behind the dynamic-batching ``serving.ServingEngine`` and its
HTTP front end (``serving.serve``).  A training loop survives a NaN, a
SIGTERM and a restart under ``train_guard.TrainGuard`` (crash-safe
``checkpoint``s, bit-exact resume); ``profiler`` and ``memory`` give the
reference's profiler and allocator surfaces.  Programs run on
one device, the card (``cuda:0``) unless the caller passes
``CPUPlace()`` / ``device="cpu"``; on the card each feed signature's
step is captured once as a CUDA graph and replayed
(framework/executor.py).

The port imports neither jax nor ``paddle_tpu``.
"""
# the lock-order sanitizer must patch threading BEFORE any module
# constructs its locks, so this hook runs first (no-op unless
# FLAGS_debug_lock_order is set in the environment)
from . import locksan as _locksan  # noqa: E402
_locksan.install_from_flag()

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
from . import checkpoint  # noqa
from . import train_guard  # noqa
from . import profiler  # noqa
from . import memory  # noqa
from . import serving  # noqa
from .framework.backward import append_backward, gradients  # noqa
from .framework import ir  # noqa

__version__ = "0.1.0"
