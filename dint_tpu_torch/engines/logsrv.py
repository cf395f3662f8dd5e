"""log_server: the batched replication-log append server (the port of
`dint_tpu.engines.logsrv`; the reference appends in XDP,
log_server/ebpf/ls_kern.c:40-78). A batch's LOG_APPEND lanes land in the
multi-lane ring (tables/log.py) in one scatter and are ACKed.
"""
from __future__ import annotations

import torch

from ..tables import log as logring
from .types import Batch, Op, Replies, Reply


def step(ring: logring.LogRing, batch: Batch):
    """Append one batch, in place. Returns (ring, replies)."""
    do = batch.op == Op.LOG_APPEND
    ring, _, _ = logring.append(ring, do, batch.table,
                                torch.zeros_like(batch.op), batch.key_hi,
                                batch.key_lo, batch.ver, batch.val)
    rtype = torch.where(do, Reply.ACK, Reply.NONE).to(torch.int32)
    return ring, Replies(rtype=rtype, val=torch.zeros_like(batch.val),
                         ver=torch.zeros_like(batch.ver))
