"""CollectiveRequest — the unit of work of the online scheduling API.

A request is one collective (AR/RS/AG) of a given size that becomes ready
at ``issue_time`` (seconds, simulation clock).  Backward-pass gradient
buckets, pipeline-stage activations, or multi-tenant jobs each map to a
stream of requests; requests whose service windows overlap contend for the
same network dimensions, which is where scheduling-policy differences
materialize (Rashidi et al. arXiv 2007.00156, Blink arXiv 1910.04940).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CollectiveRequest:
    """One collective to be scheduled and simulated.

    ``priority`` breaks intra-dimension service ties (higher serves first);
    ``stream`` is a free-form tag identifying the issuing stream (e.g.
    "bwd-buckets", "mp-critical-path") used for reporting; ``tenant``
    identifies the job the request belongs to on a shared fabric — the
    :class:`repro_torch.tenancy.FabricArbiter` arbitrates service between tenants
    and per-tenant metrics aggregate over it.
    """

    collective: str            # 'AR' | 'RS' | 'AG'
    size_bytes: float
    issue_time: float = 0.0
    priority: int = 0
    stream: str = "default"
    tenant: str = "default"

    def __post_init__(self):
        if self.collective not in ("AR", "RS", "AG"):
            raise ValueError(f"unsupported collective {self.collective!r}")
        if self.size_bytes < 0:
            raise ValueError("size_bytes must be >= 0")
        if self.issue_time < 0:
            raise ValueError("issue_time must be >= 0")
