"""Row-word index math of interleaved value arrays (the part of
`dint_tpu.tables.dense` that tables/kv.py uses)."""
from __future__ import annotations

import torch


def row_word_idx(idx: torch.Tensor, val_words: int) -> torch.Tensor:
    """Flat word indices [R, VW] of rows [R] in an interleaved value array
    (row r's words at [r*VW, (r+1)*VW)); int64."""
    return (idx.to(torch.int64)[:, None] * val_words
            + torch.arange(val_words, device=idx.device)[None])
