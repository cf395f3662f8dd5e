"""The serving plane (the port of `dint_tpu.serve`): open-loop arrival
schedules (`arrivals`) fill variable-occupancy cohorts, `ServeEngine`
pumps them through the engines' serve runners, and the SLO controller
(`controller`) picks the cohort width among a menu and sheds, never
stalls, past saturation. `MeshServeEngine` (`mesh`) serves SmallBank over
the whole 2-D (dcn x ici) mesh: per-host admission, one global
controller, width switches drained on every partition."""
from __future__ import annotations

from .arrivals import (ArrivalStream, burst_schedule,  # noqa: F401
                       constant_schedule, make_schedule, poisson_schedule)
from .controller import (ControllerCfg, ServiceModel,  # noqa: F401
                         WidthController, choose_width, max_backlog,
                         recommend_hot_frac, simulate_widths)
from .engine import (RealClock, ServeEngine, VirtualClock,  # noqa: F401
                     block_seed, cached_runner)
from .mesh import MeshServeEngine                        # noqa: F401
