"""SmallBank and TATP workload constants (smallbank/caladan/smallbank.h:
16-18,29-50,63-69; tatp/caladan/tatp.h:40-63), SmallBank's skewed cohorts,
TATP's NURand ids, the lock microbenchmarks' traces, the txn-mix
thresholds, YCSB-E's scan shape and the store's Zipfian keys; the same
values and numpy draws as `dint_tpu.clients.workloads`."""
from __future__ import annotations

import numpy as np

SB_AMALGAMATE = 0
SB_BALANCE = 1
SB_DEPOSIT = 2
SB_SEND_PAYMENT = 3
SB_TRANSACT_SAVING = 4
SB_WRITE_CHECK = 5

# mix percentages, smallbank/caladan/smallbank.h:63-69
SB_MIX = np.array([15, 15, 15, 25, 15, 15], np.float64) / 100.0
SB_MAGIC = 0x5B5B
SB_HOT_FRAC = 0.04        # 960k of 24M accounts
SB_HOT_PROB = 0.9         # 90% of txns hit the hot set


def sb_sample_accounts(rng: np.random.Generator, n: int, n_accounts: int,
                       hot_frac: float = SB_HOT_FRAC,
                       hot_prob: float = SB_HOT_PROB):
    """Skewed account ids: ``hot_prob`` of the draws fall in the hot set,
    the first ``hot_frac`` of the keyspace; the rest are uniform."""
    hot_n = max(int(n_accounts * hot_frac), 1)
    is_hot = rng.random(n) < hot_prob
    return np.where(is_hot,
                    rng.integers(0, hot_n, size=n),
                    rng.integers(0, n_accounts, size=n)).astype(np.int64)


def sb_make_txns(rng: np.random.Generator, n: int, n_accounts: int,
                 mix=SB_MIX, **skew):
    """A cohort of SmallBank txns: (type [n] i32, a1 [n], a2 [n] int64);
    a2 moves off a1 where they clash (two-account txns need two)."""
    ttype = rng.choice(6, size=n, p=mix).astype(np.int32)
    a1 = sb_sample_accounts(rng, n, n_accounts, **skew)
    a2 = sb_sample_accounts(rng, n, n_accounts, **skew)
    a2 = np.where(a1 == a2, (a2 + 1) % n_accounts, a2)
    return ttype, a1, a2

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


def nurand(rng: np.random.Generator, a: int, n: int, size: int):
    """TATP non-uniform subscriber id in [1, n] (tatp/caladan/tatp.h:40-43)."""
    x = rng.integers(0, a + 1, size=size)
    y = rng.integers(1, n + 1, size=size)
    return ((x | y) % n) + 1


def lock_trace(rng: np.random.Generator, n_txns: int = 20_000,
               locks_per_txn=(5, 10), key_range: int = 4800,
               read_prop: float = 0.8):
    """The 2PL/FaSST trace: per txn, 5-10 distinct keys in sorted order,
    each read with probability ``read_prop``, else written
    (lock_2pl/caladan/trace_init.sh:6-25). Returns a list of (keys [k]
    int64 ascending, is_read [k] bool)."""
    txns = []
    for _ in range(n_txns):
        k = int(rng.integers(locks_per_txn[0], locks_per_txn[1] + 1))
        keys = np.sort(rng.choice(key_range, size=k, replace=False))
        is_read = rng.random(k) < read_prop
        txns.append((keys.astype(np.int64), is_read))
    return txns


def mix_thresholds(mix) -> np.ndarray:
    """Cumulative u32 thresholds for sampling a txn type from one uniform
    u32 word via ``searchsorted(thresh, word, side="right")``, clamped to
    len(mix)-1. Normalizes ``mix``; the last threshold clips to 0xFFFFFFFF."""
    m = np.asarray(mix, np.float64)
    c = np.cumsum(m / m.sum())
    return (c * 2.0**32).astype(np.uint64).clip(0, 0xFFFFFFFF) \
        .astype(np.uint32)


# YCSB-E: 95% scans, lengths uniform in [1, 100]
YCSB_E_SCAN_FRAC = 0.95
YCSB_E_MAX_SCAN = 100


def scan_lengths(rng: np.random.Generator, n: int, max_len: int,
                 min_len: int = 1) -> np.ndarray:
    """Uniform scan lengths in [min_len, max_len] (YCSB-E's default scan
    length distribution); the engine clips them to its scan_max."""
    assert 1 <= min_len <= max_len
    return rng.integers(min_len, max_len + 1, size=n).astype(np.uint32)


# ----------------------------------------------------------------- zipf

ZIPF_THETA = 0.99          # YCSB's default skew

_zipf_cdf_cache: dict[tuple[int, float], np.ndarray] = {}


def zipf_cdf(n_keys: int, theta: float = ZIPF_THETA) -> np.ndarray:
    """CDF of the Zipfian rank distribution P(k) ∝ 1/k^theta over ranks
    [1, n_keys], cached per (n_keys, theta)."""
    key = (int(n_keys), float(theta))
    cdf = _zipf_cdf_cache.get(key)
    if cdf is None:
        w = 1.0 / np.power(np.arange(1, n_keys + 1, dtype=np.float64),
                           theta)
        cdf = np.cumsum(w / w.sum())
        _zipf_cdf_cache[key] = cdf
    return cdf


def zipf_keys(rng: np.random.Generator, n: int, n_keys: int,
              theta: float = ZIPF_THETA) -> np.ndarray:
    """Zipfian key ids in [1, n_keys] with rank == key id: the hot head is
    the smallest ids, the hot tier's prefix."""
    u = rng.random(n)
    k = np.searchsorted(zipf_cdf(n_keys, theta), u, side="right") + 1
    return np.clip(k, 1, n_keys).astype(np.uint64)


def zipf_scan_starts(rng: np.random.Generator, n: int, n_keys: int,
                     theta: float = ZIPF_THETA) -> np.ndarray:
    """YCSB-E start keys: Zipfian over the keyspace with `zipf_keys`'
    rank == key id alignment, so scans over the ordered run's hot head
    touch the rows the point workloads' skew touches."""
    return zipf_keys(rng, n, n_keys, theta)


def ycsb_e_ops(rng: np.random.Generator, n: int, n_keys: int,
               scan_frac: float = YCSB_E_SCAN_FRAC,
               max_len: int = YCSB_E_MAX_SCAN,
               theta: float = ZIPF_THETA):
    """One YCSB-E-shaped cohort for the store: scans with Zipfian start
    keys and uniform lengths, the rest upsert writes. Returns (is_scan [n]
    bool, keys [n] u64, scan_len [n] u32, zero on write lanes), a function
    of the generator's state."""
    is_scan = rng.random(n) < scan_frac
    starts = zipf_scan_starts(rng, n, n_keys, theta)
    writes = zipf_keys(rng, n, n_keys, theta)
    keys = np.where(is_scan, starts, writes)
    lens = np.where(is_scan, scan_lengths(rng, n, max_len), 0) \
        .astype(np.uint32)
    return is_scan, keys, lens
