"""The discrete-event engine in PyTorch (port of ``repro.core``)."""
from . import (engine, farm, jobs, power, scheduler, server, telemetry,
               types, workload)
