"""TATP workload constants (tatp/caladan/tatp.h:40-63) and the txn-mix
thresholds; the same values as `dint_tpu.clients.workloads`."""
from __future__ import annotations

import numpy as np

TATP_GET_SUBSCRIBER = 0
TATP_GET_ACCESS = 1
TATP_GET_NEW_DEST = 2
TATP_UPDATE_SUBSCRIBER = 3
TATP_UPDATE_LOCATION = 4
TATP_INSERT_CF = 5
TATP_DELETE_CF = 6

# mix percentages, tatp/caladan/tatp.h:57-63
TATP_MIX = np.array([35, 35, 10, 2, 14, 2, 2], np.float64) / 100.0
TATP_A = 1048575  # NURand A, tatp/caladan/tatp.h:40-43


def mix_thresholds(mix) -> np.ndarray:
    """Cumulative u32 thresholds for sampling a txn type from one uniform
    u32 word via ``searchsorted(thresh, word, side="right")``, clamped to
    len(mix)-1. Normalizes ``mix``; the last threshold clips to 0xFFFFFFFF."""
    m = np.asarray(mix, np.float64)
    c = np.cumsum(m / m.sum())
    return (c * 2.0**32).astype(np.uint64).clip(0, 0xFFFFFFFF) \
        .astype(np.uint32)
