"""The discrete-event engine in PyTorch (port of ``repro.core``)."""
from . import (engine, farm, jobs, montecarlo, network, power, scheduler,
               server, shard_sim, telemetry, topology, trace, traceio, types,
               workload)
