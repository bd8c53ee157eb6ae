"""Graph-building layer functions (the port's subset of
``paddle_tpu/layers``)."""
from .nn import *  # noqa
from .tensor import *  # noqa
from .loss import *  # noqa
from .learning_rate_scheduler import *  # noqa
from .metric_op import *  # noqa
from .sequence import *  # noqa
from . import nn  # noqa
from . import tensor  # noqa
from . import loss  # noqa
from . import learning_rate_scheduler  # noqa
from . import metric_op  # noqa
from . import math_op_patch  # noqa
from . import sequence  # noqa
from .control_flow import cond, While, Switch, while_loop, Print  # noqa
from . import control_flow  # noqa
# after the submodule: the name ``rnn`` is the function, as in the JAX
# package
from .rnn import (RNNCell, GRUCell, LSTMCell, rnn, birnn,  # noqa
                  BeamSearchDecoder, dynamic_decode, beam_search,
                  beam_search_decode, gather_tree)
