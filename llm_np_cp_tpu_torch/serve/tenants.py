"""Tenant identity (port of ``llm_np_cp_tpu/serve/tenants.py``, its
validator only).

``normalize_tenant`` is the one validator every surface shares: tenant
strings come from untrusted HTTP headers and bodies, so the charset is
whitelisted to ``[A-Za-z0-9._-]`` and the length capped — a string that
passes is Prometheus-label-safe and JSON-safe verbatim.  The HTTP
protocol needs it to parse a request; the engine records the tenant on
each request.

The rest of the JAX module — ``TenantLedger`` (per-tenant cost and SLO
accounting, the fair-share admission order and the in-flight cap that
raises ``TenantThrottled``) and ``aggregate_tenants`` — is the tenants
slice, not ported yet.
"""

from __future__ import annotations

import string
from typing import Any

DEFAULT_TENANT = "default"
#: Hard cap on tenant-id length; also the charset whitelist below.
#: Everything that passes is Prometheus-label- and JSON-safe verbatim.
TENANT_MAX_LEN = 64
_TENANT_CHARS = frozenset(string.ascii_letters + string.digits + "._-")


def normalize_tenant(value: Any) -> str:
    """Validate/normalize one tenant id from an untrusted source.

    ``None`` and ``""`` mean "no tenant" → ``"default"``.  Anything else
    must be a string of at most ``TENANT_MAX_LEN`` characters drawn from
    ``[A-Za-z0-9._-]``.  Raises ``ValueError`` with an actionable message
    otherwise (the HTTP layer maps it to a 400)."""
    if value is None or value == "":
        return DEFAULT_TENANT
    if not isinstance(value, str):
        raise ValueError(f"tenant must be a string, got {type(value).__name__}")
    if len(value) > TENANT_MAX_LEN:
        raise ValueError(f"tenant id exceeds {TENANT_MAX_LEN} characters ({len(value)})")
    bad = set(value) - _TENANT_CHARS
    if bad:
        shown = "".join(sorted(bad))
        raise ValueError(
            f"tenant id contains disallowed characters {shown!r} "
            "(allowed: letters, digits, '.', '_', '-')"
        )
    return value
