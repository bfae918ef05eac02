"""The discrete-event engine in PyTorch (port of ``repro.core``)."""
from . import (engine, farm, jobs, montecarlo, network, power, scheduler,
               server, telemetry, topology, trace, traceio, types, workload)
