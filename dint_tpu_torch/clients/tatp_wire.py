"""The TATP coordinator over the wire (the port of
`dint_tpu.clients.tatp_wire`): whole transactions against three UDP shard
servers.

The reference's TATP client fans each transaction's per-shard messages out
to three shard servers over UDP (tatp/caladan/client_ebpf_shard.cc:636-677,
servers tatp/udp/server_shard.cc). `serve_shards` starts three
`EnginePump`s, one TATP shard each with its own socket, RX batching and
`tatp.step`, and `WireCoordinator` drives `tatp_client.Coordinator`'s
cohorts with every wave sent as 55-byte datagrams through `ShimClient`s.

The MSG55 ``ord`` field is a u8, so one socket can match at most 256
datagrams in flight: a shard's lanes go out in chunks of 256 spread over
``n_socks`` sockets, each its own ord space, and replies are put back in
lane order by the echoed ord. A lane that gets no answer is re-sent on its
own socket; after ``max_tries`` it answers Reply.TIMEOUT and its txn counts
as ab_timeout (the reference re-sends forever; a capped budget has to give
a number and a timeout count instead). A reply whose ord, key and table
match no lane still outstanding is a straggler of an earlier try and is
dropped (the reference's ``assert(msg.key == key)``). A re-sent OCC_LOCK
whose first GRANT was lost finds its own lock and reads REJECT; on loopback
no reply is lost.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from ..engines import tatp
from ..engines.types import Op, Reply
from ..shim import TATP, EnginePump, ShimClient
from ..shim.native import VAL_SIZE
from . import tatp_client as tc

N_SHARDS = tc.N_SHARDS
_CHUNK = 256        # u8 ord field: most datagrams one exchange can match

# engine op -> wire request code (the inverse of TATP.req_map)
_OP2WIRE = np.full(64, 255, np.uint8)
for _w, _op in enumerate(TATP.req_map):
    if _op != Op.NOP:
        _OP2WIRE[_op] = _w

# (wire request, wire reply) -> engine Reply code (the inverse of rep_map)
_WIRE2REP = np.full((64, 256), Reply.NONE, np.int32)
for _w in range(TATP.rep_map.shape[0]):
    for _r in range(TATP.rep_map.shape[1]):
        _code = TATP.rep_map[_w, _r]
        if _code >= 0:
            _WIRE2REP[_w, _code] = _r


@contextlib.contextmanager
def serve_shards(n_subscribers: int, width: int = 1024, val_words: int = 10,
                 flush_us: int = 500, seed: int = 0, device=None, **kw):
    """Three shard servers on loopback UDP (the reference runs one process
    a shard, tatp/udp/server_shard.cc), each over one replica of
    `tatp_client.populate_shards` on ``device`` (None = CUDA) from
    ``seed``, ``kw`` going to `tatp.create`; yields their ports."""
    shards, _ = tc.populate_shards(np.random.default_rng(seed),
                                   n_subscribers, val_words=val_words,
                                   device=device, **kw)
    pumps = []
    try:
        for s in shards:
            pumps.append(EnginePump(TATP, tatp.step, s, width=width,
                                    flush_us=flush_us, val_words=val_words,
                                    device=device).start())
        yield [p.port for p in pumps]
    finally:
        for p in pumps:
            p.close()


class WireCoordinator(tc.Coordinator):
    """`tatp_client.Coordinator` with every wave sent to three UDP servers.

    It keeps the whole transaction logic of `run_cohort` (the mix, NURand,
    the waves, the abort taxonomy, the magic check) and replaces only the
    transport, as the reference's UDP and Caladan clients share theirs. It
    holds no shard, so `Coordinator.__init__` is not called: `run_cohort`
    reads only ``attr``, ``p``, ``width``, ``vw`` and ``stats``."""

    def __init__(self, ports, n_subscribers: int, width: int = 4096,
                 val_words: int = 10, host: str = "127.0.0.1",
                 timeout_ms: int = 10_000, max_tries: int = 8,
                 n_socks: int = 4):
        self.p = n_subscribers
        self.width = width
        self.vw = val_words
        self.attr = False
        self.stats = tc.Stats()
        self.timeout_ms = timeout_ms
        self.max_tries = max_tries
        # n_socks sockets a shard, each its own u8 ord space: a shard holds
        # up to n_socks * 256 requests in flight
        self.clients = [[ShimClient(host, p) for _ in range(n_socks)]
                        for p in ports]

    def close(self):
        for socks in self.clients:
            for c in socks:
                c.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _exchange_chunk(self, client, chunk, lo, ops, tbls, keys, vals,
                        vers, rt, rv, rver, wire_req) -> int:
        """One chunk of <= 256 lanes on one socket: send, put the replies
        in lane order by their echoed ord, re-send what went unanswered.
        Writes this chunk's own slice of rt/rv/rver; returns the count of
        lanes that timed out."""
        pend = chunk
        for _ in range(self.max_tries):
            if len(pend) == 0:
                return 0
            wv = np.zeros((len(pend), VAL_SIZE), np.uint8)
            wv[:, : self.vw * 4] = np.ascontiguousarray(
                vals[pend, : self.vw].astype(np.uint32)
            ).view(np.uint8).reshape(len(pend), -1)
            # an ord is the lane's place in its chunk on every try, so a
            # straggler of an earlier try maps back to the lane that sent
            # it (renumbering a try could credit a same-key lane)
            r = client.exchange(
                wire_req[pend], keys[pend].astype(np.uint64),
                tables=tbls[pend].astype(np.uint8), vals=wv,
                vers=vers[pend].astype(np.uint32),
                ords=(pend - lo).astype(np.uint8),
                timeout_ms=self.timeout_ms)
            n = r["n"]
            if n == 0:
                continue
            # ord -> lane of the chunk; the echoed key and table must be
            # what that lane sent, else the reply is dropped
            ordv = r["ord"][:n].astype(np.int64)
            ok = ordv < len(chunk)
            cand = chunk[np.where(ok, ordv, 0)]
            ok &= (r["key"][:n] == keys[cand].astype(np.uint64)) \
                & (r["table"][:n] == tbls[cand].astype(np.uint8))
            # a straggler for a lane a later try already answered must not
            # overwrite that answer (an OCC_LOCK could flip GRANT/REJECT)
            ok &= np.isin(cand, pend)
            idx = cand[ok]
            if len(idx):
                sel_n = np.nonzero(ok)[0]
                rt[idx] = _WIRE2REP[wire_req[idx], r["type"][:n][sel_n]]
                got_v = r["val"][:n][sel_n].reshape(len(sel_n), VAL_SIZE)
                rv[idx] = np.ascontiguousarray(
                    got_v[:, : self.vw * 4]).view(np.uint32).reshape(
                        len(sel_n), -1)
                rver[idx] = r["ver"][:n][sel_n]
                pend = pend[~np.isin(pend, idx)]
        # the re-send budget ran out: a counted timeout, not a void run
        # (run_cohort counts these txns as ab_timeout)
        rt[pend] = Reply.TIMEOUT
        return len(pend)

    def _exchange_shard(self, s, ops, tbls, keys, vals, vers):
        """One shard's lanes in chunks of 256, the chunks spread over the
        shard's sockets and sent concurrently (an exchange blocks in C with
        the GIL released, so the chunks overlap on the wire)."""
        m = len(ops)
        rt = np.full(m, Reply.NONE, np.int32)
        rv = np.zeros((m, self.vw), np.uint32)
        rver = np.zeros(m, np.uint32)
        wire_req = _OP2WIRE[ops]
        chunks = [(lo, np.arange(lo, min(lo + _CHUNK, m)))
                  for lo in range(0, m, _CHUNK)]
        socks = self.clients[s]
        timeouts = [0] * len(socks)

        def worker(wi):
            # socket wi sends chunks wi, wi + n_socks, ... in turn
            for ci in range(wi, len(chunks), len(socks)):
                lo, chunk = chunks[ci]
                timeouts[wi] += self._exchange_chunk(
                    socks[wi], chunk, lo, ops, tbls, keys, vals, vers,
                    rt, rv, rver, wire_req)

        if len(chunks) == 1:
            worker(0)
        else:
            ts = [threading.Thread(target=worker, args=(wi,))
                  for wi in range(min(len(socks), len(chunks)))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        return rt, rv, rver, sum(timeouts)

    def _run_wave(self, ops, tbls, keys, shard_of=None, vals=None,
                  vers=None):
        """The wave's non-NOP lanes, one thread a shard (the reference's
        three coordinator threads, client_ebpf_shard.cc:636-677); returns
        the replies in lane order."""
        m = len(ops)
        rt = np.full(m, Reply.NONE, np.int32)
        rv = np.zeros((m, self.vw), np.uint32)
        rver = np.zeros(m, np.uint32)
        if vals is None:
            vals = np.zeros((m, self.vw), np.uint32)
        if vers is None:
            vers = np.zeros(m, np.uint32)
        if shard_of is None:
            shard_of = keys % N_SHARDS
        active = ops != Op.NOP
        errs = []
        tmo = [0] * N_SHARDS

        def one(s, idx):
            try:
                srt, srv, srver, stmo = self._exchange_shard(
                    s, ops[idx], tbls[idx], keys[idx], vals[idx],
                    vers[idx])
                rt[idx] = srt
                rv[idx] = srv
                rver[idx] = srver
                tmo[s] = stmo
            except Exception as e:      # raised after the join
                errs.append(e)

        threads = []
        for s in range(N_SHARDS):
            idx = np.nonzero(active & (shard_of == s))[0]
            if len(idx):
                threads.append(threading.Thread(target=one, args=(s, idx)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        self.stats.timeout_lanes += sum(tmo)  # after the join: one thread
        return rt, rv, rver
