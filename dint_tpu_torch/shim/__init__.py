"""The native host shim: the C++ UDP request pump, the wire-format profiles
and the pump that serves an engine over them."""
from .native import (FMT_FASST9, FMT_LOCK6, FMT_LOG53, FMT_MSG55, VAL_SIZE,
                     ShimClient, ShimServer)
from .pump import EnginePump
from .wire import FASST, LOCK2PL, LOG, PROFILES, SMALLBANK, STORE, TATP

__all__ = ["ShimClient", "ShimServer", "EnginePump", "PROFILES", "STORE",
           "LOCK2PL", "FASST", "LOG", "SMALLBANK", "TATP", "VAL_SIZE",
           "FMT_MSG55", "FMT_LOCK6", "FMT_FASST9", "FMT_LOG53"]
