"""Dependency-free Kubernetes core-API client (pods) over REST + JSON.

Equivalent capability: the pod surface of the reference's k8sClient
(dlrover/python/scheduler/kubernetes.py:121), which wraps the official
``kubernetes`` package. That package is heavyweight and absent from
lean TPU images; the API server itself speaks plain REST, so this
client implements exactly the calls PodScaler/PodWatcher need with the
standard library only — and makes the scheduler testable against a real
(fake) HTTP API server instead of monkeypatched methods.

Pods come back as :class:`ApiObject` wrappers giving the attribute
access the rest of the scheduler uses (``pod.metadata.labels``,
``pod.status.host_ip``), with snake_case -> camelCase JSON mapping.

The PyTorch port's copy of dlrover_tpu/scheduler/rest_client.py.
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(part.title() for part in rest)


class ApiObject:
    """Read-only attribute view over a JSON dict (nested)."""

    def __init__(self, data: dict):
        self._data = data or {}

    def __getattr__(self, name: str):
        data = object.__getattribute__(self, "_data")
        for key in (name, _snake_to_camel(name)):
            if key in data:
                value = data[key]
                return ApiObject(value) if isinstance(value, dict) \
                    else value
        # acronym-bearing keys ("hostIP") defeat naive camelCase;
        # fall back to case/underscore-insensitive matching
        want = name.replace("_", "").lower()
        for key, value in data.items():
            if key.replace("_", "").lower() == want:
                return ApiObject(value) if isinstance(value, dict) \
                    else value
        return None

    def get(self, key, default=None):
        """dict-style access — pod labels are read with .get() by
        pod_to_node, matching the official client's plain-dict labels."""
        value = self._data.get(key, default)
        return ApiObject(value) if isinstance(value, dict) else value

    def to_dict(self) -> dict:
        return self._data

    def __repr__(self):
        return f"ApiObject({self._data!r})"


class RestK8sClient:
    """The pod API surface of K8sClient, stdlib-only.

    ``base_url`` resolution order: explicit argument, the
    ``DLROVER_TPU_K8S_API`` env var, then the in-cluster service env
    (``KUBERNETES_SERVICE_HOST``/``_PORT`` with the service-account
    token and CA).
    """

    def __init__(self, base_url: str | None = None,
                 namespace: str = "default",
                 token: str | None = None,
                 ca_cert: str | None = None):
        if base_url is None:
            base_url = os.environ.get("DLROVER_TPU_K8S_API", "")
        explicit_endpoint = bool(base_url)
        self._token_file = None
        if not base_url and os.environ.get("KUBERNETES_SERVICE_HOST"):
            host = os.environ["KUBERNETES_SERVICE_HOST"]
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
        if not base_url:
            raise RuntimeError(
                "no k8s API endpoint: set DLROVER_TPU_K8S_API or run "
                "in-cluster"
            )
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        # The mounted service-account token is auto-attached ONLY when
        # the endpoint came from the in-cluster service env — an
        # arbitrary DLROVER_TPU_K8S_API URL must not silently receive
        # the cluster credential (an attacker-controlled env var would
        # exfiltrate it). Explicit endpoints pass ``token=`` or opt in
        # via DLROVER_TPU_K8S_SA_TOKEN=1; plain http never gets it.
        sa_opt_in = os.environ.get("DLROVER_TPU_K8S_SA_TOKEN") == "1"
        if self.base_url.startswith("https") and (
            not explicit_endpoint or sa_opt_in
        ):
            token_file = os.path.join(_SA_DIR, "token")
            if token is None and os.path.exists(token_file):
                # bound SA tokens rotate on disk (kubelet) — remember
                # the path, re-read per request
                self._token_file = token_file
        elif (
            explicit_endpoint
            and token is None
            and self.base_url.startswith("https")
            and os.path.exists(os.path.join(_SA_DIR, "token"))
        ):
            # make the deliberate auth hardening diagnosable: a secured
            # apiserver reached via DLROVER_TPU_K8S_API now returns
            # 401/403 unless the SA token is explicitly opted in
            logger.info(
                "explicit https endpoint %s used without credentials; "
                "the mounted service-account token is NOT auto-attached "
                "— pass token= or set DLROVER_TPU_K8S_SA_TOKEN=1 to "
                "authenticate", self.base_url,
            )
        self._token = token
        self._ssl_ctx = None
        if self.base_url.startswith("https"):
            # system trust store PLUS (not instead of) the cluster CA:
            # an explicit endpoint may sit behind a publicly-signed
            # proxy while in-cluster servers use the self-signed SA CA
            self._ssl_ctx = ssl.create_default_context(cafile=ca_cert)
            if ca_cert is None:
                ca_file = os.path.join(_SA_DIR, "ca.crt")
                if os.path.exists(ca_file):
                    self._ssl_ctx.load_verify_locations(cafile=ca_file)

    # ------------------------------------------------------------- http

    def _request(self, method: str, path: str, body=None, query=None,
                 timeout: float = 30.0, content_type: str | None = None):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header(
                "Content-Type", content_type or "application/json"
            )
        token = self._token
        if token is None and self._token_file:
            with open(self._token_file) as f:
                token = f.read().strip()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        return urllib.request.urlopen(
            req, timeout=timeout, context=self._ssl_ctx
        )

    def _pods_path(self) -> str:
        return f"/api/v1/namespaces/{self.namespace}/pods"

    def _crd_path(self, plural: str) -> str:
        from dlrover_tpu_torch.scheduler.crd import GROUP, VERSION

        return (
            f"/apis/{GROUP}/{VERSION}/namespaces/{self.namespace}/{plural}"
        )

    # ------------------------------------------- custom-resource verbs

    def list_custom_resources(self, plural: str, label_selector: str = ""):
        """List namespaced CRs (e.g. ``scaleplans``) as raw manifests."""
        query = {"labelSelector": label_selector} if label_selector else None
        with self._request(
            "GET", self._crd_path(plural), query=query
        ) as resp:
            return json.loads(resp.read().decode()).get("items", [])

    def create_custom_resource(self, plural: str, manifest: dict) -> bool:
        with self._request("POST", self._crd_path(plural), body=manifest):
            pass
        return True

    def update_custom_resource_status(
        self, plural: str, name: str, status: dict
    ) -> bool:
        """Merge-patch a CR's status subresource. PATCH with
        application/merge-patch+json is what real API servers accept
        for a partial {"status": ...} body (a PUT replace would demand
        the full object + resourceVersion)."""
        with self._request(
            "PATCH", f"{self._crd_path(plural)}/{name}/status",
            body={"status": status},
            content_type="application/merge-patch+json",
        ):
            pass
        return True

    def delete_custom_resource(self, plural: str, name: str) -> bool:
        try:
            with self._request(
                "DELETE", f"{self._crd_path(plural)}/{name}"
            ):
                pass
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    # -------------------------------------------------------- pod verbs

    def create_pod(self, pod_spec: dict) -> bool:
        with self._request("POST", self._pods_path(), body=pod_spec):
            pass
        return True

    def delete_pod(self, name: str) -> bool:
        with self._request(
            "DELETE", f"{self._pods_path()}/{name}"
        ):
            pass
        return True

    def list_pods(self, label_selector: str):
        with self._request(
            "GET", self._pods_path(),
            query={"labelSelector": label_selector},
        ) as resp:
            data = json.loads(resp.read().decode())
        return ApiObject({
            "items": [ApiObject(p) for p in data.get("items", [])]
        })

    def watch_pods(self, label_selector: str, timeout: int):
        """Yield {"type": ..., "object": ApiObject} events (the k8s
        watch protocol: one JSON document per line).

        Connection failures PROPAGATE (like the official client's
        watch): the master's monitor loop catches them and backs off —
        a silently-empty generator would turn that loop into a hot spin
        against a down API server."""
        resp = self._request(
            "GET", self._pods_path(),
            query={
                "labelSelector": label_selector,
                "watch": "true",
                "timeoutSeconds": str(int(timeout)),
            },
            timeout=timeout + 5,
        )
        with resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line.decode())
                except ValueError:
                    continue
                yield {
                    "type": event.get("type", "MODIFIED"),
                    "object": ApiObject(event.get("object") or {}),
                }
