"""Admission webhooks: the typed ingress for pods, nodes, quotas, and
the SLO configmaps (counterpart of ``koordinator_tpu/webhook``).

The reference's pkg/webhook/: pod mutation
(ClusterColocationProfile injection + batch/mid resource translation,
pod/mutating/cluster_colocation_profile.go), pod validation
(pod/validating/cluster_colocation_profile.go), the ElasticQuota
topology guard (elasticquota/quota_topology.go), node amplification
admit/validate (node/plugins/resourceamplification), and the SLO
configmap checkers (cm/plugins/sloconfig).
"""

from koordinator_tpu_torch.webhook.mutating import (  # noqa: F401
    ClusterColocationProfile,
    PodMutatingWebhook,
)
from koordinator_tpu_torch.webhook.validating import (  # noqa: F401
    PodValidatingWebhook,
)
from koordinator_tpu_torch.webhook.quota_topology import (  # noqa: F401
    QuotaTopologyGuard,
    QuotaTopologyError,
)
from koordinator_tpu_torch.webhook.node import (  # noqa: F401
    NodeMutatingWebhook,
    NodeValidatingWebhook,
)
from koordinator_tpu_torch.webhook.cm import (  # noqa: F401
    SLOConfigValidatingWebhook,
)
