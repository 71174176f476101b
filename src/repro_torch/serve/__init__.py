"""Serving: the CA simulation service (``engine``), its admission-control
/ fair-scheduling layer (``admission``), its fault injector (``faults``)
and the LM serving engine (``lm_engine``)."""
from repro_torch.serve.admission import (AdmissionError,  # noqa: F401
                                         DeadlineInfeasible, QueueFull,
                                         RateLimited, TenantConfig,
                                         UnknownTenant, jain_index)
from repro_torch.serve.engine import (DONE, PARKED,  # noqa: F401
                                      QUARANTINED, QUEUED, RUNNING, SHED,
                                      CAServeEngine, DrainTimeout, SimJob)
from repro_torch.serve.faults import (Fault, FaultEvent,  # noqa: F401
                                      FaultInjector, SimulatedCrash,
                                      make_schedule)
from repro_torch.serve.lm_engine import Request, ServeEngine  # noqa: F401
