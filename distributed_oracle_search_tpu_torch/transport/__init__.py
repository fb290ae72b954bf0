"""Head↔worker data plane: the wire formats, the FIFO campaign
transport, the streaming RPC transport (:mod:`.frames` length-prefixed
frames over :mod:`.rpc` persistent multiplexed sockets,
``DOS_TRANSPORT={fifo,rpc,auto}``), job launch, liveness probes and
head-side resilience (retries, circuit breakers, failover over
replicas). Copies of the JAX package's modules, so the two packages'
heads and workers drive each other."""

from .wire import (
    ENGINE_STAT_FIELDS, HEAD_STAT_FIELDS, STATS_HEADER,
    HealthStatus, Request, RuntimeConfig, StatsRow,
    read_query_file, write_query_file,
)
from .fifo import (
    RetryPolicy, answer_fifo_path, clean_stale_answer_fifos,
    command_fifo_path, fan_out, probe, send, send_with_retry,
)
from .launch import kill_session, launch, session_name
from .resilience import BreakerRegistry, CircuitBreaker

__all__ = [
    "ENGINE_STAT_FIELDS", "HEAD_STAT_FIELDS", "STATS_HEADER",
    "HealthStatus", "Request", "RuntimeConfig", "StatsRow",
    "read_query_file", "write_query_file",
    "RetryPolicy", "answer_fifo_path", "clean_stale_answer_fifos",
    "command_fifo_path", "fan_out", "probe", "send", "send_with_retry",
    "kill_session", "launch", "session_name",
    "BreakerRegistry", "CircuitBreaker",
]
