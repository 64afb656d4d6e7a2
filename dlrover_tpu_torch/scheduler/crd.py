"""ElasticJob / ScalePlan CRD schemas and manifest generation.

Equivalent capability: reference dlrover/go/operator/api/v1alpha1/
elasticjob_types.go:29 (ElasticJobSpec: DistributionStrategy,
OptimizeMode, ReplicaSpecs with RestartCount/AutoScale/Priority) and
scaleplan_types.go:110 (ScalePlanSpec). The Go operator's reconciler
creates the per-job master pod and lets it drive; on GKE/JobSet the
master can run operator-less — these dataclasses give the same job
description either way: parse a submitted CR (dict from the k8s API) or
emit a manifest to apply.

The PyTorch port's copy of dlrover_tpu/scheduler/crd.py. A replica's
``tpu_chips`` (the field name of the port's ``NodeResource``) asks for
``nvidia.com/gpu``, the card's extended resource.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

GROUP = "elastic.iml.github.io"
VERSION = "v1alpha1"


def parse_cpu_quantity(v) -> float:
    """K8s CPU quantity: 2, "2", "500m" -> cores."""
    if v is None or v == "":
        return 0.0
    s = str(v).strip()
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    return float(s)


_MEM_SUFFIX_MB = {
    "Ki": 1.0 / 1024, "Mi": 1.0, "Gi": 1024.0, "Ti": 1024.0 * 1024,
    "K": 1e3 / (1 << 20), "M": 1e6 / (1 << 20), "G": 1e9 / (1 << 20),
    "T": 1e12 / (1 << 20),
}


def parse_memory_quantity_mb(v) -> int:
    """K8s memory quantity: "32Gi", "512Mi", "1000000Ki", plain bytes
    -> MiB. Unknown forms raise instead of silently becoming 0."""
    if v is None or v == "" or v == 0:
        return 0
    s = str(v).strip()
    for suffix in ("Ki", "Mi", "Gi", "Ti", "K", "M", "G", "T"):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * _MEM_SUFFIX_MB[suffix])
    # plain number = bytes per the k8s convention
    return int(float(s) / (1 << 20))


@dataclass
class ReplicaSpec:
    """One replica group (worker / ps / chief / evaluator)."""

    replicas: int = 0
    restart_count: int = 3
    auto_scale: bool = True
    priority: str = ""
    cpu: float = 0.0
    memory_mb: int = 0
    tpu_chips: int = 0
    image: str = ""
    command: list = field(default_factory=list)

    def to_dict(self) -> dict:
        resources = {}
        if self.cpu:
            resources["cpu"] = self.cpu
        if self.memory_mb:
            resources["memory"] = f"{self.memory_mb}Mi"
        if self.tpu_chips:
            resources["nvidia.com/gpu"] = self.tpu_chips
        template: dict = {"spec": {"containers": [{
            "name": "main",
            "image": self.image,
            "command": self.command,
            "resources": {"requests": resources, "limits": resources},
        }]}}
        return {
            "replicas": self.replicas,
            "restartCount": self.restart_count,
            "autoScale": self.auto_scale,
            "priority": self.priority,
            "template": template,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaSpec":
        spec = cls(
            replicas=int(d.get("replicas", 0)),
            restart_count=int(d.get("restartCount", 3)),
            auto_scale=bool(d.get("autoScale", True)),
            priority=d.get("priority", ""),
        )
        containers = (
            d.get("template", {}).get("spec", {}).get("containers", [])
        )
        if containers:
            c = containers[0]
            spec.image = c.get("image", "")
            spec.command = c.get("command", [])
            req = c.get("resources", {}).get("requests", {})
            spec.cpu = parse_cpu_quantity(req.get("cpu", 0))
            spec.memory_mb = parse_memory_quantity_mb(
                req.get("memory", 0)
            )
            spec.tpu_chips = int(req.get("nvidia.com/gpu", 0) or 0)
        return spec


@dataclass
class ElasticJobSpec:
    job_name: str = ""
    namespace: str = "default"
    distribution_strategy: str = "AllreduceStrategy"
    optimize_mode: str = "single-job"
    brain_service: str = ""
    replica_specs: dict = field(default_factory=dict)  # type -> ReplicaSpec

    def to_manifest(self) -> dict:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ElasticJob",
            "metadata": {
                "name": self.job_name,
                "namespace": self.namespace,
            },
            "spec": {
                "distributionStrategy": self.distribution_strategy,
                "optimizeMode": self.optimize_mode,
                "brainService": self.brain_service,
                "replicaSpecs": {
                    t: s.to_dict() for t, s in self.replica_specs.items()
                },
            },
        }

    def to_yaml(self) -> str:
        return _to_yaml(self.to_manifest())

    @classmethod
    def from_manifest(cls, manifest: dict) -> "ElasticJobSpec":
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})
        return cls(
            job_name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            distribution_strategy=spec.get(
                "distributionStrategy", "AllreduceStrategy"
            ),
            optimize_mode=spec.get("optimizeMode", "single-job"),
            brain_service=spec.get("brainService", ""),
            replica_specs={
                t: ReplicaSpec.from_dict(d)
                for t, d in spec.get("replicaSpecs", {}).items()
            },
        )


@dataclass
class ScalePlanSpec:
    """Manual/auto scaling request (reference scaleplan_types.go:110)."""

    job_name: str = ""
    namespace: str = "default"
    name: str = ""
    replica_counts: dict = field(default_factory=dict)  # type -> count
    node_resources: dict = field(default_factory=dict)  # name -> {cpu,mem}
    manual: bool = True

    def to_manifest(self) -> dict:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ScalePlan",
            "metadata": {
                "name": self.name or f"{self.job_name}-scaleplan",
                "namespace": self.namespace,
                "labels": {"elasticjob-name": self.job_name},
            },
            "spec": {
                "ownerJob": self.job_name,
                "manualScaling": self.manual,
                "replicaResourceSpecs": {
                    t: {"replicas": c}
                    for t, c in self.replica_counts.items()
                },
                "migratePods": [
                    {"name": n, "resource": r}
                    for n, r in self.node_resources.items()
                ],
            },
        }

    def to_yaml(self) -> str:
        return _to_yaml(self.to_manifest())

    @classmethod
    def from_manifest(cls, manifest: dict) -> "ScalePlanSpec":
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})
        return cls(
            job_name=spec.get(
                "ownerJob", meta.get("labels", {}).get(
                    "elasticjob-name", ""
                )
            ),
            namespace=meta.get("namespace", "default"),
            name=meta.get("name", ""),
            replica_counts={
                t: int(d.get("replicas", 0))
                for t, d in spec.get(
                    "replicaResourceSpecs", {}
                ).items()
            },
            node_resources={
                m["name"]: m.get("resource", {})
                for m in spec.get("migratePods", [])
                if m.get("name")
            },
            manual=bool(spec.get("manualScaling", True)),
        )


def _to_yaml(obj, indent: int = 0) -> str:
    """Minimal YAML emitter (no external deps; manifests are plain
    dict/list/scalar trees)."""
    pad = "  " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}"
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        if not obj:
            return pad + "[]"
        lines = []
        for item in obj:
            if isinstance(item, (dict, list)) and item:
                body = _to_yaml(item, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}")
                if rest:
                    lines.append(rest)
            else:
                lines.append(f"{pad}- {_scalar(item)}")
        return "\n".join(lines)
    return pad + _scalar(obj)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if v is None or v == {}:
        return "{}"
    if v == []:
        return "[]"
    return json.dumps(str(v))
