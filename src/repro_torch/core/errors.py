"""Fault taxonomy shared across the serving, routing, and retrieval
layers.

Lives in ``core`` (stdlib-only, no heavy deps) so the retrieval layer
can raise/catch these without importing the serving package and vice
versa.  The continuous engine's executor-fault handling keys on
:class:`TransientFaultError`.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for injected and detected serving-plane faults."""


class TransientFaultError(FaultError):
    """A fault worth retrying: the operation may succeed if repeated
    (retriever brownout, timeout, transient executor failure).  The
    gateway retry path and the circuit breakers key on this type."""


class FaultTimeoutError(TransientFaultError):
    """An injected (or detected) operation timeout."""


class CircuitOpenError(TransientFaultError):
    """A call was refused because the target's circuit breaker is
    open — transient by definition: the breaker will probe again."""

    def __init__(self, name: str, message: str = ""):
        super().__init__(message or f"circuit open for {name!r}")
        self.name = name
