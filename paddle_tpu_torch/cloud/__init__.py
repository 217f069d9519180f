"""Cloud/elastic training services: the task-dispatch master, the
TTL-lease registry and the elastic readers over them (counterpart of
paddle_tpu/cloud/).

The rebuild of the reference's Go cloud layer (Paddle's go/):
fault-tolerant dataset dispatch (go/master/service.go) with stateless,
elastic trainers (doc/design/cluster_train/README.md), and pserver
membership with TTL leases (go/pserver/etcd_client.go).  The master and
the registry are native C++ (native/src/master.cc, registry.cc, the
JAX package's sources); this package is their Python surface.

The elastic cluster (cluster.py: ClusterView, ClusterController,
ClusterClient) is here; the serving front door (router, autoscaler) is
ROADMAP A11's second half: its names raise naming it.
"""
from .cluster import ClusterClient, ClusterController, ClusterView
from .master import Master, MasterClient, task_record_reader
from .registry import Lease, Registry, RegistryClient, resolve_pserver_cluster

__all__ = ["Master", "MasterClient", "task_record_reader",
           "Registry", "RegistryClient", "Lease", "resolve_pserver_cluster",
           "ClusterView", "ClusterController", "ClusterClient",
           "ReplicaRouter", "NoReplicasAvailable",
           "Autoscaler", "AutoscalerPolicy",
           "SubprocessReplicaLauncher"]

_SECOND_HALF = ("ReplicaRouter", "NoReplicasAvailable", "Autoscaler",
                "AutoscalerPolicy", "SubprocessReplicaLauncher", "router",
                "autoscaler")


def __getattr__(name):
    if name in _SECOND_HALF:
        raise NotImplementedError(
            f"paddle_tpu_torch.cloud.{name}: the serving front door "
            "(cloud/router.py, cloud/autoscaler.py) is not ported yet "
            "(ROADMAP A11's second half)")
    raise AttributeError(name)
