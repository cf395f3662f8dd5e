"""The least bytes a step of a cell must move through device memory, and
the table of peaks: the yardstick of ``device.hbm_roofline_share``.

The bytes follow from the configuration and the traffic mix alone, never
from the route that implements them, so the share reads the same work
whatever moves it: each input byte read once and each output byte
written once, for the expected transaction of the mix (every read-write
transaction's writes counted as if it commits):

* the step's draws (4-byte words) read once;
* each row a transaction reads: its version word and its value words;
* each lock it takes: its lock words read and its stamp written (TATP
  one lock word, SmallBank an exclusive and a shared stamp);
* each write it commits: the row (version and value words) installed,
  one log entry (4 header words and the value words) in each log
  replica, and the row written to each backup copy.
"""
from __future__ import annotations

# Published peak bandwidth of device memory by card name (NVIDIA's data
# sheets; the H100 SXM's 3.35 TB/s assumes its full 700 W).
PEAK_BYTES_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

# per transaction type: (rows read, locks taken, rows written)
TATP_SHAPE = [(1, 0, 0),    # get subscriber data
              (1, 0, 0),    # get access data
              (2, 0, 0),    # get new destination
              (2, 2, 2),    # update subscriber data
              (2, 1, 1),    # update location
              (2, 1, 1),    # insert call forwarding
              (1, 1, 1)]    # delete call forwarding
SMALLBANK_SHAPE = [(3, 3, 3),    # amalgamate
                   (2, 2, 0),    # balance
                   (1, 1, 1),    # deposit checking
                   (2, 2, 2),    # send payment
                   (1, 1, 1),    # transact savings
                   (2, 2, 1)]    # write check

LOG_HEADER_WORDS = 4


def step_bytes(cfg: dict, mix: dict) -> float:
    """The least bytes one step moves, over all of the cell's servers."""
    system = cfg["system"]
    w = mix["width"] * cfg.get("servers", 1)
    shares = cfg["mix"]
    if system == "smallbank_dense":
        shape, row_words, lock_words, draw_words = SMALLBANK_SHAPE, 1, 3, 6
        entry_words = LOG_HEADER_WORDS + 2
    else:
        vw = cfg["val_words"]
        shape, row_words, lock_words, draw_words = TATP_SHAPE, 1 + vw, 2, 6
        entry_words = LOG_HEADER_WORDS + vw
    reads = sum(p * s[0] for p, s in zip(shares, shape))
    locks = sum(p * s[1] for p, s in zip(shares, shape))
    writes = sum(p * s[2] for p, s in zip(shares, shape))
    per_txn = (draw_words
               + reads * row_words
               + locks * lock_words
               + writes * (row_words
                           + cfg["log_replicas"] * entry_words
                           + cfg["backups"] * row_words))
    return 4.0 * w * per_txn / sum(shares)


def peak(card: str):
    """The card's peak bytes a second, or None for a card not listed."""
    return PEAK_BYTES_S.get(card)
