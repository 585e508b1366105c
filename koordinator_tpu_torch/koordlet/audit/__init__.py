"""The node agent's audit log (counterpart of
``koordinator_tpu/koordlet/audit``)."""

from koordinator_tpu_torch.koordlet.audit.auditor import AuditEvent, Auditor

__all__ = ["AuditEvent", "Auditor"]
