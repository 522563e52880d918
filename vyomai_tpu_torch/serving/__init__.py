from .engine import ContinuousBatchEngine  # noqa: F401
from .kv_manager import PagedKVManager, SequenceState, RadixNode  # noqa: F401
from . import paged_model  # noqa: F401
