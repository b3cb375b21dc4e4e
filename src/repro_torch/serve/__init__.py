"""Continuous-batching serve subsystem on compiled execution plans.

- ``queue``      — admission queue + request types (lm / tree / lattice)
- ``scheduler``  — continuous folding of arrivals into in-flight waves,
                   wave-as-graph builders
- ``engine``     — round-driven engine: compiled plan path (one CUDA-graph
                   replay per bucket signature on the card, one for all K
                   replicas of a sharded engine), slot pools, shared FIFO
                   caches, ``ServeStats``
- ``registry``   — persistent FSM policy registry (content fingerprints)
- ``traces``     — synthetic request traces
- ``faults``     — error codes, validation, quarantine, fault injection
- ``checkpoint`` — versioned, fingerprinted session snapshots (atomic IO)
- ``resilience`` — snapshot/restore, elastic mesh resize, work stealing
- ``compiler``   — supervised background build service (async compile:
                   bucket graphs captured on worker threads)
- ``lm_wave``    — wave-by-wave TransformerLM engine (baseline)
"""

from .checkpoint import (CheckpointError, latest_checkpoint, list_checkpoints,
                         read_checkpoint, write_checkpoint)
from .engine import ServeEngine, ServeStats, serve_trace
from .faults import FaultInjector, InjectedCrash, Quarantine
from .queue import (AdmissionQueue, ServeRequest, graph_request, lm_request,
                    reserve_rids)
from .registry import PolicyRegistry
from .scheduler import ContinuousScheduler, partition_singles
from .traces import ARRIVALS, synth_arrivals, synth_trace

__all__ = ["ServeEngine", "ServeStats", "serve_trace", "AdmissionQueue",
           "ServeRequest", "graph_request", "lm_request", "reserve_rids",
           "PolicyRegistry", "ContinuousScheduler", "partition_singles",
           "ARRIVALS", "synth_arrivals", "synth_trace", "CheckpointError",
           "read_checkpoint", "write_checkpoint", "list_checkpoints",
           "latest_checkpoint", "FaultInjector", "InjectedCrash",
           "Quarantine"]
