"""Op library: importing it registers every ported op."""
from . import registry  # noqa
from . import tensor_ops  # noqa
from . import math_ops  # noqa
from . import nn_ops  # noqa
from . import attention_ops  # noqa
from . import decode_ops  # noqa
from . import rope_ops  # noqa
from . import control_flow_ops  # noqa
from . import optimizer_ops  # noqa
from . import amp_ops  # noqa
from . import catalog_seq_ops  # noqa
