"""W3C-style trace context across the fleet's processes: counterpart of
`alphatriangle_tpu/telemetry/tracectx.py`.

A `(trace_id, span_id, parent_id)` triple is minted once per causal unit
(a routed request at the router, a replica incarnation at the fleet
supervisor) and carried across every process boundary: the replica's
JSON-lines protocol (the router stamps the request, the replica echoes
it and threads it into its `serve/b<B>` flight bracket), the
`ALPHATRIANGLE_TRACEPARENT` env seam from a spawning parent to its
child, and the ledgers, where the fields are plain optional keys that
every reader takes with `dict.get`. The wire form is traceparent-shaped
(`00-<trace>-<span>-01`). Stdlib only.
"""

import os
import re
from dataclasses import dataclass

#: Env var carrying a parent context to spawned children (the
#: supervisor's per-attempt seam; serving/fleet.py uses it per replica
#: incarnation). Same propagation idiom as `ALPHATRIANGLE_SUPERVISE_OVERRIDES`.
TRACEPARENT_ENV = "ALPHATRIANGLE_TRACEPARENT"

#: The record field names, shared by every writer so readers can grep
#: one spelling. Legacy records simply lack them.
TRACE_ID_FIELD = "trace_id"
SPAN_ID_FIELD = "span_id"
PARENT_ID_FIELD = "parent_id"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars (W3C width)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id, 16 lowercase hex chars (W3C width)."""
    return os.urandom(8).hex()


@dataclass(frozen=True)
class TraceContext:
    """One span's identity: which trace it belongs to, its own id, and
    the span that caused it (None for a root span)."""

    trace_id: str
    span_id: str
    parent_id: "str | None" = None

    def child(self) -> "TraceContext":
        """A new span caused by this one (same trace, fresh span id)."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            parent_id=self.span_id,
        )

    def fields(self) -> dict:
        """The ledger/payload fields for this context (parent_id only
        when set, so root spans stay two fields)."""
        out = {
            TRACE_ID_FIELD: self.trace_id,
            SPAN_ID_FIELD: self.span_id,
        }
        if self.parent_id:
            out[PARENT_ID_FIELD] = self.parent_id
        return out

    def to_traceparent(self) -> str:
        """W3C traceparent wire form (version 00, sampled flag)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, value: "str | None") -> "TraceContext | None":
        """Parse the wire form; None on anything malformed (a child
        must never crash over a corrupt env var)."""
        if not isinstance(value, str):
            return None
        m = _TRACEPARENT_RE.match(value.strip().lower())
        if m is None:
            return None
        return cls(trace_id=m.group(1), span_id=m.group(2))

    @classmethod
    def from_fields(cls, record: "dict | None") -> "TraceContext | None":
        """Recover a context from a ledgered record's fields; None when
        the record predates tracing (the legacy-tolerance contract)."""
        if not isinstance(record, dict):
            return None
        trace_id = record.get(TRACE_ID_FIELD)
        span_id = record.get(SPAN_ID_FIELD)
        if not (isinstance(trace_id, str) and trace_id):
            return None
        return cls(
            trace_id=trace_id,
            span_id=span_id if isinstance(span_id, str) and span_id else new_span_id(),
            parent_id=record.get(PARENT_ID_FIELD) or None,
        )


def mint(parent: "TraceContext | None" = None) -> TraceContext:
    """Mint a span context: a child of `parent` when given (same
    trace), else a fresh root trace (router per request, supervisor
    per attempt with no inherited context)."""
    if parent is not None:
        return parent.child()
    return TraceContext(trace_id=new_trace_id(), span_id=new_span_id())


def from_env(environ: "dict | None" = None) -> "TraceContext | None":
    """The context a parent process handed this one via the env seam,
    or None (standalone run / legacy parent)."""
    environ = os.environ if environ is None else environ
    return TraceContext.from_traceparent(environ.get(TRACEPARENT_ENV))


def child_env(
    ctx: "TraceContext | None", environ: "dict | None" = None
) -> dict:
    """A copy of `environ` with the traceparent seam set (or cleared
    when ctx is None, so a child never inherits a stale context)."""
    env = dict(os.environ if environ is None else environ)
    if ctx is None:
        env.pop(TRACEPARENT_ENV, None)
    else:
        env[TRACEPARENT_ENV] = ctx.to_traceparent()
    return env


def trace_fields(payload: "dict | None") -> dict:
    """Extract just the trace fields present on a payload/record —
    empty dict for legacy id-less records, so `**trace_fields(req)`
    composes with writers unconditionally."""
    if not isinstance(payload, dict):
        return {}
    out = {}
    for key in (TRACE_ID_FIELD, SPAN_ID_FIELD, PARENT_ID_FIELD):
        value = payload.get(key)
        if isinstance(value, str) and value:
            out[key] = value
    return out
