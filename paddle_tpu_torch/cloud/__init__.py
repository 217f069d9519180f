"""Cloud/elastic training services: the task-dispatch master, the
TTL-lease registry and the elastic readers over them (counterpart of
paddle_tpu/cloud/).

The rebuild of the reference's Go cloud layer (Paddle's go/):
fault-tolerant dataset dispatch (go/master/service.go) with stateless,
elastic trainers (doc/design/cluster_train/README.md), and pserver
membership with TTL leases (go/pserver/etcd_client.go).  The master and
the registry are native C++ (native/src/master.cc, registry.cc, the
JAX package's sources); this package is their Python surface.

The serving front door (router, autoscaler) and the elastic cluster
controller are ROADMAP A11's second slice: their names raise naming
it.
"""
from .master import Master, MasterClient, task_record_reader
from .registry import Lease, Registry, RegistryClient, resolve_pserver_cluster

__all__ = ["Master", "MasterClient", "task_record_reader",
           "Registry", "RegistryClient", "Lease", "resolve_pserver_cluster",
           "ReplicaRouter", "NoReplicasAvailable",
           "Autoscaler", "AutoscalerPolicy",
           "SubprocessReplicaLauncher"]

_SECOND_SLICE = ("ReplicaRouter", "NoReplicasAvailable", "Autoscaler",
                 "AutoscalerPolicy", "SubprocessReplicaLauncher", "router",
                 "autoscaler", "cluster")


def __getattr__(name):
    if name in _SECOND_SLICE:
        raise NotImplementedError(
            f"paddle_tpu_torch.cloud.{name}: the serving front door and "
            "the elastic cluster (cloud/router.py, cloud/autoscaler.py, "
            "cloud/cluster.py) are not ported yet (ROADMAP A11's second "
            "slice)")
    raise AttributeError(name)
