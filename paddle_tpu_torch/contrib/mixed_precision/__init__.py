"""Static-graph automatic mixed precision (counterpart of
``paddle_tpu/contrib/mixed_precision/``)."""
from .fp16_lists import AutoMixedPrecisionLists  # noqa
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa
