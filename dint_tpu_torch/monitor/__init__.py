"""The observability plane of the port (the port of `dint_tpu.monitor`).

* `counters` — the counter registry and the `Counters` buffer engines
  bump in-step; the host reads it between blocks.
* `trace` — the host half: wave-event JSONL (`TraceWriter`, `Monitor`),
  Chrome-trace export, and the torch.profiler session.
* `waves` / `attrib` — dintscope, the timing half: the append-only
  wave-name registry behind the engines' `waves.scope` annotations, and
  the attribution that charges a torch.profiler trace's device time to
  those waves. ``python -m dint_tpu_torch.dintscope`` is its CLI.
* `txnevents` / `txntrace` — dinttrace, the narration half: the
  per-transaction event ring that rides a runner's carry, and the span
  assembler. ``python -m dint_tpu_torch.dinttrace`` is its CLI.

Every plane is off by default and adds nothing to a step when off.
``python -m dint_tpu_torch.dintmon`` reads the counter artifacts.
"""
from __future__ import annotations

from .counters import (ALL_NAMES, COUNTER_DOCS, COUNTER_INDEX,  # noqa: F401
                       COUNTER_KINDS, FLOW_NAMES, GAUGE_NAMES, N_COUNTERS,
                       PARITY_NAMES, Counters, bump, create, delta,
                       gauge_max, snapshot, zeros_dict)
from .counters import (CTR_STEPS, CTR_TXN_ATTEMPTED,  # noqa: F401
                       CTR_TXN_COMMITTED, CTR_AB_LOCK, CTR_AB_MISSING,
                       CTR_AB_VALIDATE, CTR_AB_LOGIC, CTR_MAGIC_BAD,
                       CTR_LOCK_REQUESTS, CTR_LOCK_GRANTED,
                       CTR_LOCK_REJECTED, CTR_LOCK_REJECT_HELD,
                       CTR_LOCK_REJECT_ARB, CTR_VALIDATE_LANES,
                       CTR_VALIDATE_FAILED, CTR_INSTALL_WRITES,
                       CTR_LOG_APPENDS, CTR_REPL_PUSH_HOP1,
                       CTR_REPL_PUSH_HOP2, CTR_ROUTE_OVERFLOW,
                       CTR_RING_HWM, CTR_DISPATCH_XLA, CTR_DISPATCH_PALLAS,
                       CTR_HOT_HITS, CTR_HOT_COLD_ROWS,
                       CTR_HOT_REFRESH_BYTES, CTR_TRACE_DROPPED,
                       CTR_SERVE_OCC_LANES, CTR_SERVE_PAD_LANES,
                       CTR_SERVE_SHED_LANES)
from .trace import (Monitor, TraceWriter, export_chrome_trace,  # noqa: F401
                    profiler_session, read_events)
from . import attrib, waves  # noqa: F401, E402
from . import txnevents, txntrace  # noqa: F401, E402
