"""contrib namespace: static-graph mixed precision."""
from . import mixed_precision  # noqa
