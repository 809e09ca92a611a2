"""The rule catalogue. ``all_rules()`` builds one fresh instance of every
registered rule — order is the order findings are attributed in, and the
``rule_id`` strings here are STABLE: ``--json`` consumers (doctor folding,
CI annotations) key on them, which is why the torch counterparts of two JAX
rules (``rng-reuse``, ``pspec-literal``) keep the JAX ids. The JAX
package's ``retrace-hazard`` and ``use-after-donate`` have no subject in the
port (``engine.NOT_PORTED``)."""
from __future__ import annotations

from typing import List

from ..engine import Rule
from .host_sync import HostSyncRule
from .hot_loop import HotLoopEmitRule
from .pspec import PspecLiteralRule
from .rng import RngReuseRule
from .sockets import SocketTimeoutRule
from .telemetry_schema import TelemetrySchemaRule
from .threads import ThreadSharedStateRule

RULE_CLASSES = [
    HostSyncRule,
    RngReuseRule,
    ThreadSharedStateRule,
    TelemetrySchemaRule,
    SocketTimeoutRule,
    PspecLiteralRule,
    HotLoopEmitRule,
]


def all_rules() -> List[Rule]:
    return [cls() for cls in RULE_CLASSES]
