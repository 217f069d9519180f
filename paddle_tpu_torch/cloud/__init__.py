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
ClusterClient) and the serving front door (router.py: ReplicaRouter;
autoscaler.py: Autoscaler, AutoscalerPolicy, SubprocessReplicaLauncher)
are here; the front door loads on first use, so cloud-only users
(masters, pservers, cluster controllers) stay light.
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


def __getattr__(name):
    if name in ("ReplicaRouter", "NoReplicasAvailable"):
        from . import router

        return getattr(router, name)
    if name in ("Autoscaler", "AutoscalerPolicy",
                "SubprocessReplicaLauncher"):
        from . import autoscaler

        return getattr(autoscaler, name)
    raise AttributeError(name)
