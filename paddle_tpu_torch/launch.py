"""Cluster launcher — the reference's cluster_train scripts rebuilt
(counterpart of the JAX package's tools/launch.py, inside the package:
``python -m paddle_tpu_torch.launch ...``).

Reference: Paddle's paddle/scripts/cluster_train/paddle.py (ssh
fabric launcher setting PADDLE_INIT_* env), cluster_train_v2/{fabric,
openmpi}, and the book_distribute env-var convention
(tests/book_distribute/notest_dist_fit_a_line.py:43-60: PSERVERS /
TRAINING_ROLE / SERVER_ENDPOINT / PADDLE_INIT_TRAINER_ID).

Two modes:

1. pserver cluster (CPU hosts, DistributeTranspiler pserver mode):
       python -m paddle_tpu_torch.launch --pservers 2 --trainers 2 \
           train.py [args...]
   Spawns the script once per role-instance with the reference's env-var
   convention; pserver endpoints are auto-assigned on localhost.  For a
   multi-host cluster, pass --endpoints with ALL pserver endpoints and run
   one launcher per host spawning only that host's share, using
   --pserver-offset to pick which endpoints this host serves:
       hostA$ launch.py --endpoints A:7164,B:7164 --pservers 1 \
                  --pserver-offset 0 --trainers 2 train.py
       hostB$ launch.py --endpoints A:7164,B:7164 --pservers 1 \
                  --pserver-offset 1 --trainers 2 train.py

2. multi-host SPMD (torch.distributed process groups):
       python -m paddle_tpu_torch.launch --coordinator host0:1234 \
           --num-processes 4 --process-id 0 train.py [args...]
   Exports the coordination env (the etcd-membership analogue) and runs
   the script; paddle_tpu_torch.parallel.init_distributed() picks it
   up.

3. registry-discovered pserver cluster (the reference's etcd flow):
       python -m paddle_tpu_torch.launch --registry --pservers 2 \
           --trainers 2 train.py
   The launcher hosts a TTL-lease registry (cloud.registry); pservers
   bind their own ports, register under kept-alive leases, trainers
   discover — no static endpoint list, and a dead pserver's slot frees
   for a replacement.  The script resolves its role via
   cloud.registry.resolve_pserver_cluster().

Pservers run on the host; trainers run on the card their script asks
for (the entry points' default, CUDAPlace(0)).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

__all__ = ["launch_pserver_cluster", "launch_registry_cluster", "main"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_registry_cluster(script, script_args, n_pservers, n_trainers,
                            python=sys.executable):
    """Registry mode: NO static endpoint list.  The launcher hosts a
    TTL-lease registry (paddle_tpu_torch.cloud.registry); pservers pick their
    own ports and register, trainers discover — the reference's etcd
    flow (go/cmd/pserver/pserver.go) instead of PSERVERS env plumbing.
    The script resolves its role via
    `cloud.registry.resolve_pserver_cluster()`.

    Returns (registry, [(role, proc)...]); stop the registry after the
    trainers exit."""
    from .cloud.registry import Registry

    reg = Registry()
    rport = reg.serve(0)
    reg.set_desired("pserver", n_pservers)
    base = dict(os.environ,
                PADDLE_TPU_REGISTRY=f"127.0.0.1:{rport}",
                PADDLE_TPU_NUM_PSERVERS=str(n_pservers),
                PADDLE_INIT_NUM_GRADIENT_SERVERS=str(n_trainers))
    procs = []
    for _ in range(n_pservers):
        env = dict(base, TRAINING_ROLE="PSERVER")
        procs.append(("pserver",
                      subprocess.Popen([python, script] + script_args,
                                       env=env)))
    for i in range(n_trainers):
        env = dict(base, TRAINING_ROLE="TRAINER",
                   PADDLE_INIT_TRAINER_ID=str(i))
        procs.append(("trainer",
                      subprocess.Popen([python, script] + script_args,
                                       env=env)))
    return reg, procs


def launch_pserver_cluster(script, script_args, n_pservers, n_trainers,
                           endpoints=None, pserver_offset=0,
                           python=sys.executable, **trainer_popen_kwargs):
    """Spawn pserver + trainer processes with the book_distribute env-var
    convention; returns the list of (role, proc).

    `endpoints` lists the FULL cluster's pservers; this call serves
    eps[pserver_offset : pserver_offset+n_pservers] (multi-host: one call
    per host with its own offset).  `trainer_popen_kwargs` apply to the
    TRAINER Popen calls only (e.g. stdout=PIPE to harvest results);
    pservers deliberately inherit stdio — nobody drains their pipes, and
    a full unread pipe would block the server."""
    eps = (endpoints.split(",") if endpoints else
           [f"127.0.0.1:{_free_port()}" for _ in range(n_pservers)])
    if pserver_offset + n_pservers > len(eps):
        raise ValueError(
            f"--pservers {n_pservers} at offset {pserver_offset} exceeds "
            f"the {len(eps)} endpoints given")
    procs = []
    for i, ep in enumerate(eps[pserver_offset:pserver_offset + n_pservers]):
        env = dict(os.environ,
                   PSERVERS=",".join(eps),
                   TRAINING_ROLE="PSERVER",
                   SERVER_ENDPOINT=ep,
                   PADDLE_INIT_NUM_GRADIENT_SERVERS=str(n_trainers))
        procs.append(("pserver",
                      subprocess.Popen([python, script] + script_args,
                                       env=env)))
    for i in range(n_trainers):
        env = dict(os.environ,
                   PSERVERS=",".join(eps),
                   TRAINING_ROLE="TRAINER",
                   PADDLE_INIT_TRAINER_ID=str(i),
                   PADDLE_INIT_NUM_GRADIENT_SERVERS=str(n_trainers))
        procs.append(("trainer",
                      subprocess.Popen([python, script] + script_args,
                                       env=env, **trainer_popen_kwargs)))
    return procs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.launch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pservers", type=int, default=0)
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--endpoints", default=None,
                    help="comma-separated pserver endpoints of the FULL "
                         "cluster (default: auto-assign localhost ports)")
    ap.add_argument("--pserver-offset", type=int, default=0,
                    help="index into --endpoints of this host's first "
                         "pserver (multi-host)")
    ap.add_argument("--registry", action="store_true",
                    help="host a TTL-lease registry instead of static "
                         "endpoints; pservers self-register, trainers "
                         "discover (script must use "
                         "cloud.registry.resolve_pserver_cluster)")
    ap.add_argument("--coordinator", default=None,
                    help="torch.distributed coordinator address "
                         "host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    if args.coordinator:
        # multi-host SPMD: one process per host, env consumed by
        # parallel.mesh.init_distributed()
        if args.num_processes is None or args.process_id is None:
            ap.error("--coordinator requires --num-processes and "
                     "--process-id (otherwise each host silently runs an "
                     "independent single-host job)")
        env = dict(os.environ,
                   PADDLE_TPU_COORDINATOR=args.coordinator,
                   PADDLE_TPU_NUM_PROCESSES=str(args.num_processes),
                   PADDLE_TPU_PROCESS_ID=str(args.process_id))
        sys.exit(subprocess.call([sys.executable, args.script] +
                                 args.script_args, env=env))

    reg = None
    if args.registry:
        if args.endpoints or args.pserver_offset:
            ap.error("--registry discovers endpoints dynamically; "
                     "--endpoints/--pserver-offset only apply to the "
                     "static mode")
        reg, procs = launch_registry_cluster(
            args.script, args.script_args, args.pservers, args.trainers)
    else:
        procs = launch_pserver_cluster(args.script, args.script_args,
                                       args.pservers, args.trainers,
                                       args.endpoints, args.pserver_offset)
    rc = 0
    # trainers finishing ends the job; pservers are then terminated
    # (the reference's fabric launcher kills pservers the same way)
    for role, p in procs:
        if role == "trainer":
            rc |= p.wait()
    for role, p in procs:
        if role == "pserver" and p.poll() is None:
            p.terminate()
    for role, p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
    if reg is not None:
        reg.close()
    sys.exit(rc)


if __name__ == "__main__":
    main()
