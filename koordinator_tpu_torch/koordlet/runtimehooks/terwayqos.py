"""Terway network-QoS hook: render node/pod bandwidth config files.

Reference: pkg/koordlet/runtimehooks/hooks/terwayqos/terwayqos.go — the
terway CNI dataplane reads two files under ``/host-var-lib/terway/qos``:

- ``global_bps_config``: node-level three-tier (L0/L1/L2) bandwidth
  splits derived from the NodeSLO (SystemStrategy.TotalNetworkBandwidth
  + per-class NetworkQOS, :270-311 parseNetQoS, LS -> L1, BE -> L2);
- ``pod.json``: per-pod priority + ingress/egress limits from the pod
  net-QoS annotation (:373-395 getPodQoS) and QoS class (:397-409
  getPodPrio — koord QoS label first, then kube QoS tier).

The hook is enabled iff the NodeSLO's policy selector names terway
(``netQOSPolicy == "terway-qos"``, :95-99); disabling removes both files
(:200-203, :233-236). Writes are cached (skip-if-unchanged) and audited,
the same guarantees the reference gets by routing through its executor's
common updater.

Bandwidth quantities follow the reference: ints are percentages of the
node total, strings absolute bits/s; stored values are Bytes/s
(:337 BitsToBytes).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/terwayqos.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from koordinator_tpu_torch.apis.extension import LABEL_QOS_CLASS, QoSClass
from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    KubeQOS,
    kube_qos_by_cgroup_parent,
)
from koordinator_tpu_torch.manager.sloconfig import NetworkQOS, NodeSLOSpec

NAME = "TerwayQoS"
POD_CONFIG = "pod.json"
NODE_CONFIG = "global_bps_config"
NET_QOS_POLICY_KEY = "netQOSPolicy"
NET_QOS_POLICY_TERWAY = "terway-qos"

#: pod net-QoS annotation (reference: extension.AnnotationNetworkQOS)
ANNOTATION_NET_QOS = "koordinator.sh/networkQOS"

#: LabelPodQoS -> terway priority (terwayqos.go prioMapping)
_PRIO_BY_QOS = {
    QoSClass.LSE.value: 0,
    QoSClass.LSR.value: 0,
    QoSClass.LS.value: 1,
    QoSClass.BE.value: 2,
}


def bits_to_bytes(bits: int) -> int:
    return int(bits) // 8


class QuantityError(ValueError):
    """An IntOrString bandwidth value the reference's parseQuantity
    rejects (malformed, or absolute value over the node total).  The
    rule update carrying it is discarded and the prior config kept."""


def _parse_quantity(value, total_bits: int) -> int:
    """IntOrString: int = percent of total, str = absolute bits/s;
    result Bytes/s (terwayqos.go:352-371). Malformed or over-total
    raises QuantityError — returning 0 would mean "no limit", silently
    removing the cap on a typo'd value."""
    if value is None:
        return 0
    if isinstance(value, str):
        try:
            bps = bits_to_bytes(int(float(value)))
        except ValueError as e:
            raise QuantityError(f"bad bandwidth quantity {value!r}") from e
        if bps < 0 or bps > bits_to_bytes(total_bits):
            raise QuantityError(
                f"bandwidth {value!r} outside [0, node total "
                f"{total_bits} bits/s]"
            )
        return bps
    if int(value) < 0:
        raise QuantityError(f"negative bandwidth percent {value!r}")
    return int(value) * bits_to_bytes(total_bits) // 100


def _class_tier(qos_cfg: Optional[NetworkQOS], total_bits: int) -> Dict[str, int]:
    if qos_cfg is None or not qos_cfg.enable:
        return {"rx_min": 0, "rx_max": 0, "tx_min": 0, "tx_max": 0}
    return {
        "rx_min": _parse_quantity(qos_cfg.ingress_request, total_bits),
        "rx_max": _parse_quantity(qos_cfg.ingress_limit, total_bits),
        "tx_min": _parse_quantity(qos_cfg.egress_request, total_bits),
        "tx_max": _parse_quantity(qos_cfg.egress_limit, total_bits),
    }


def parse_node_config(slo: NodeSLOSpec) -> Dict[str, int]:
    """Node tier config in Bytes/s (parseNetQoS :270-311): hardware max
    from SystemStrategy, L1 from the LS class, L2 from the BE class."""
    total = int(slo.system_strategy.total_network_bandwidth_bps)
    ls = _class_tier(slo.resource_qos_strategy.ls.network, total)
    be = _class_tier(slo.resource_qos_strategy.be.network, total)
    return {
        "hw_tx_bps_max": bits_to_bytes(total),
        "hw_rx_bps_max": bits_to_bytes(total),
        "l1_rx_bps_min": ls["rx_min"], "l1_rx_bps_max": ls["rx_max"],
        "l1_tx_bps_min": ls["tx_min"], "l1_tx_bps_max": ls["tx_max"],
        "l2_rx_bps_min": be["rx_min"], "l2_rx_bps_max": be["rx_max"],
        "l2_tx_bps_min": be["tx_min"], "l2_tx_bps_max": be["tx_max"],
    }


def pod_prio(pod: PodMeta) -> int:
    """getPodPrio (:397-409): koord QoS label first, kube tier fallback."""
    label = pod.labels.get(LABEL_QOS_CLASS)
    if label in _PRIO_BY_QOS:
        return _PRIO_BY_QOS[label]
    kube = kube_qos_by_cgroup_parent(pod.cgroup_dir)
    return 2 if kube is KubeQOS.BESTEFFORT else 1


def pod_bandwidth(pod: PodMeta) -> Dict[str, int]:
    """getPodQoS (:373-395): the pod annotation's ingress/egress limits,
    bits/s -> Bytes/s; absent/malformed -> 0 (unlimited)."""
    raw = pod.annotations.get(ANNOTATION_NET_QOS)
    if not raw:
        return {"ingress": 0, "egress": 0}
    try:
        cfg = json.loads(raw)
        return {
            "ingress": bits_to_bytes(int(float(cfg.get("ingressLimit", 0) or 0))),
            "egress": bits_to_bytes(int(float(cfg.get("egressLimit", 0) or 0))),
        }
    except (ValueError, AttributeError):
        return {"ingress": 0, "egress": 0}


class TerwayQosPlugin:
    """Config-file generator state machine (the Plugin struct)."""

    name = NAME

    def __init__(self, root_path: str, auditor: Optional[Auditor] = None):
        self.root_path = root_path
        self.auditor = auditor or Auditor()
        self.enabled: Optional[bool] = None  # None = no NodeSLO seen yet
        self.node_config: Dict[str, int] = {}
        self.pods: Dict[str, dict] = {}
        self._written: Dict[str, str] = {}  # path -> last content

    @property
    def pod_file(self) -> str:
        return os.path.join(self.root_path, POD_CONFIG)

    @property
    def node_file(self) -> str:
        return os.path.join(self.root_path, NODE_CONFIG)

    # -- rule parsing --------------------------------------------------------

    def update_node_slo(self, slo: NodeSLOSpec) -> None:
        """parseRuleForNodeSLO (:86-120) + syncNodeConfig."""
        policy = slo.resource_qos_strategy.policies.get(NET_QOS_POLICY_KEY)
        enabled = policy == NET_QOS_POLICY_TERWAY
        if enabled:
            try:
                node_config = parse_node_config(slo)
            except QuantityError as e:
                # reference parseQuantity errors reject the rule update
                # and keep the previous config (no sync)
                self.auditor.log("terwayqos", "nodeslo", "reject", str(e))
                return
            self.node_config = node_config
        self.enabled = enabled
        self.sync()

    def update_pods(self, pods) -> None:
        """The all-pods callback (:154-195) + syncPodConfig."""
        out = {}
        for pod in pods:
            bw = pod_bandwidth(pod)
            out[pod.uid] = {
                "pod_name": pod.name,
                "pod_uid": pod.uid,
                "prio": pod_prio(pod),
                "cgroup_dir": os.path.join("net_cls", pod.cgroup_dir),
                "ingress_bandwidth": bw["ingress"],
                "egress_bandwidth": bw["egress"],
            }
        self.pods = out
        self.sync()

    # -- file sync -----------------------------------------------------------

    def _write(self, path: str, content: str) -> bool:
        if self._written.get(path) == content and os.path.exists(path):
            return False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content)
        self._written[path] = content
        self.auditor.log("terwayqos", path, "update", f"-> {len(content)}B")
        return True

    def _remove(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass
        self._written.pop(path, None)

    def sync(self) -> int:
        """syncAll (:143-156): returns files written."""
        if self.enabled is None:
            return 0
        if not self.enabled:
            self._remove(self.node_file)
            self._remove(self.pod_file)
            return 0
        written = 0
        node_text = "".join(
            f"{k}={v}\n" for k, v in self.node_config.items()
        )
        if self._write(self.node_file, node_text):
            written += 1
        if self._write(self.pod_file, json.dumps(self.pods, sort_keys=True)):
            written += 1
        return written
