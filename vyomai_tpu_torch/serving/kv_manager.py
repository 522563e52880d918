"""Host-side paged-KV block manager with radix prefix caching.

The JAX package's ``vyomai_tpu/serving/kv_manager.py`` uses only the
standard library, so it is reused as it is rather than forked: it is loaded
by file path, which does not run ``vyomai_tpu/__init__.py`` (and so never
imports jax).
"""

import importlib.util
import sys
from pathlib import Path

_NAME = "vyomai_tpu_torch.serving._kv_manager_impl"
_SRC = (Path(__file__).resolve().parents[2] / "vyomai_tpu" / "serving"
        / "kv_manager.py")


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SRC)
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module
    spec.loader.exec_module(module)
    return module


_impl = _load()
PagedKVManager = _impl.PagedKVManager
SequenceState = _impl.SequenceState
RadixNode = _impl.RadixNode

__all__ = ["PagedKVManager", "SequenceState", "RadixNode"]
