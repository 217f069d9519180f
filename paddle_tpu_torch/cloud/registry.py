"""TTL-lease service registry: elastic pserver membership + liveness
(counterpart of paddle_tpu/cloud/registry.py).

Python surface over the native implementation
(`native/src/registry.cc`, the JAX package's source).  Reference semantics:
go/pserver/etcd_client.go — a pserver `Register`s under the lowest free
index with a TTL lease kept alive by heartbeats and publishes its
address; trainers discover the live address list and wait for the
desired count (go/pserver/client/etcd_client.go); an expired lease frees
the index so a replacement claims it (go/cmd/pserver/pserver.go:34-45).

Use `Registry` to host (in-process handle + optional TCP serving) and
`RegistryClient` from other processes.  `Lease` runs the heartbeat loop
on a daemon thread and exposes `lost` when the registry revoked the
slot (e.g. after a heartbeat gap longer than the TTL).
"""
from __future__ import annotations

import atexit
import ctypes
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import native
from ..core.resilience import RetryPolicy

__all__ = ["Registry", "RegistryClient", "Lease",
           "resolve_pserver_cluster"]


def _declare(lib):
    if getattr(lib, "_registry_declared", False):
        return lib
    p = ctypes.c_void_p
    i = ctypes.c_int
    i64 = ctypes.c_int64
    cp = ctypes.c_char_p
    lib.pt_registry_create.restype = p
    lib.pt_registry_create.argtypes = []
    lib.pt_registry_set_desired.argtypes = [p, cp, i]
    lib.pt_registry_register.restype = i
    lib.pt_registry_register.argtypes = [
        p, cp, cp, ctypes.c_double, ctypes.POINTER(i64)]
    lib.pt_registry_heartbeat.restype = i
    lib.pt_registry_heartbeat.argtypes = [p, cp, i, i64]
    lib.pt_registry_deregister.restype = i
    lib.pt_registry_deregister.argtypes = [p, cp, i, i64]
    lib.pt_registry_list.restype = ctypes.c_size_t
    lib.pt_registry_list.argtypes = [p, cp, cp, ctypes.c_size_t]
    lib.pt_registry_wait_ready.restype = i
    lib.pt_registry_wait_ready.argtypes = [
        p, cp, ctypes.c_size_t, ctypes.c_double]
    lib.pt_registry_serve.restype = i
    lib.pt_registry_serve.argtypes = [p, i]
    lib.pt_registry_stop.argtypes = [p]
    lib.pt_registry_destroy.argtypes = [p]
    lib._registry_declared = True
    return lib


class Registry:
    """In-process registry; `serve()` additionally exposes it over TCP."""

    def __init__(self):
        self._lib = _declare(native.lib())
        self._h = self._lib.pt_registry_create()
        self.port: Optional[int] = None

    def set_desired(self, kind: str, n: int) -> None:
        self._lib.pt_registry_set_desired(self._h, kind.encode(), n)

    def register(self, kind: str, addr: str,
                 ttl_s: float) -> Tuple[int, int]:
        """(index, lease) or raises when all desired slots are held."""
        lease = ctypes.c_int64(0)
        idx = self._lib.pt_registry_register(
            self._h, kind.encode(), addr.encode(), ttl_s,
            ctypes.byref(lease))
        if idx < 0:
            raise RuntimeError(
                f"registry: no free {kind!r} slot below the desired count")
        return idx, lease.value

    def heartbeat(self, kind: str, index: int, lease: int) -> bool:
        if not self._h:  # closed registry: definitive GONE, not a crash
            return False
        return bool(self._lib.pt_registry_heartbeat(
            self._h, kind.encode(), index, lease))

    def deregister(self, kind: str, index: int, lease: int) -> bool:
        if not self._h:  # releasing a lease after close() must be safe
            return False
        return bool(self._lib.pt_registry_deregister(
            self._h, kind.encode(), index, lease))

    def list(self, kind: str) -> Dict[int, str]:
        if not self._h:
            return {}
        # pt_registry_list returns the required length; retry bigger on
        # truncation rather than silently dropping endpoints
        size = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(size)
            need = self._lib.pt_registry_list(
                self._h, kind.encode(), buf, len(buf))
            if need < len(buf):
                break
            size = max(size * 2, need + 1)
        out: Dict[int, str] = {}
        for line in buf.value.decode().splitlines():
            if line.strip():
                idx, addr = line.split(None, 1)
                out[int(idx)] = addr
        return out

    def wait_ready(self, kind: str, n: int, timeout_s: float) -> bool:
        return bool(self._lib.pt_registry_wait_ready(
            self._h, kind.encode(), n, timeout_s))

    def serve(self, port: int = 0) -> int:
        got = self._lib.pt_registry_serve(self._h, port)
        if got < 0:
            raise RuntimeError("registry: TCP serve failed")
        self.port = got
        return got

    def stop(self) -> None:
        if self._h:
            self._lib.pt_registry_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.pt_registry_stop(self._h)
            self._lib.pt_registry_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class RegistryClient:
    """TCP client; one short-lived connection per call (the protocol is
    line-oriented and every verb is a single round trip).

    Transient transport failures (registry restarting, socket hiccup
    mid-heartbeat) retry through a RetryPolicy instead of surfacing as a
    raw OSError with no backoff; knobs are env-tunable via
    ``PADDLE_TPU_REGISTRY_RETRY_*`` (core/resilience.py).  The default
    budget is deliberately short — a heartbeat that backs off past the
    TTL is as lost as one that failed — and a RetryError still IS an
    OSError, so Lease._beat's keep-retrying loop semantics hold."""

    def __init__(self, addr: str, timeout_s: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None):
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout_s
        self.policy = retry_policy or RetryPolicy.from_env(
            "REGISTRY_RETRY", max_attempts=3, base_delay=0.05,
            max_delay=0.5, deadline=5.0)

    def _roundtrip(self, line: str, multi: bool = False) -> List[str]:
        return self.policy.call(
            lambda: self._roundtrip_once(line, multi),
            what=(f"registry at {self._addr[0]}:{self._addr[1]}: "
                  f"{line.split()[0]} failed"))

    def _connect_retrying(self, what: str) -> socket.socket:
        """A connected socket, retrying ONLY the connect phase through
        the policy.  For non-idempotent verbs (REG): once a request
        line may have reached the registry, a lost reply must surface
        instead of causing a re-send — a duplicate REG mints a ghost
        slot whose lease nobody heartbeats, and its TTL expiry later
        reads as a spurious member death."""
        return self.policy.call(
            lambda: socket.create_connection(self._addr,
                                             timeout=self._timeout),
            what=(f"registry at {self._addr[0]}:{self._addr[1]}: "
                  f"{what} failed"))

    def _roundtrip_once(self, line: str, multi: bool = False,
                        sock: Optional[socket.socket] = None) -> List[str]:
        with (sock or socket.create_connection(
                self._addr, timeout=self._timeout)) as s:
            s.sendall(line.encode() + b"\n")
            f = s.makefile("r")
            first = f.readline().strip()
            if not first:
                # clean EOF before a reply (registry restarting / closing
                # the accept): a TRANSIENT transport failure, not a
                # protocol answer — callers like Lease._beat retry on
                # OSError but treat a definitive GONE as revocation
                raise OSError(f"registry closed connection mid-request "
                              f"({line.split()[0]})")
            if not multi:
                return [first]
            lines = [first]
            while True:
                ln = f.readline()
                if not ln or ln.strip() == ".":
                    break
                lines.append(ln.rstrip("\n"))
            return lines

    def set_desired(self, kind: str, n: int) -> None:
        self._roundtrip(f"DESIRE {kind} {n}")

    def register(self, kind: str, addr: str,
                 ttl_s: float) -> Tuple[int, int]:
        # NOT via _roundtrip: REG is the one non-idempotent verb, so
        # only its connect retries (_connect_retrying docstring)
        resp = self._roundtrip_once(
            f"REG {kind} {int(ttl_s * 1000)} {addr}",
            sock=self._connect_retrying("REG connect"))[0].split()
        if resp[0] != "OK":
            raise RuntimeError(
                f"registry: no free {kind!r} slot below the desired count")
        return int(resp[1]), int(resp[2])

    def heartbeat(self, kind: str, index: int, lease: int) -> bool:
        return self._roundtrip(f"HB {kind} {index} {lease}")[0] == "OK"

    def deregister(self, kind: str, index: int, lease: int) -> bool:
        return self._roundtrip(f"DEREG {kind} {index} {lease}")[0] == "OK"

    def list(self, kind: str) -> Dict[int, str]:
        lines = self._roundtrip(f"LIST {kind}", multi=True)
        out: Dict[int, str] = {}
        for line in lines[1:]:
            if line.strip():
                idx, addr = line.split(None, 1)
                out[int(idx)] = addr
        return out

    def wait_ready(self, kind: str, n: int, timeout_s: float) -> bool:
        # server blocks up to the REMAINING window; allow socket slack
        # on top.  Transport failures retry like every other verb, but
        # each retry asks the server only for what is left of the
        # caller's timeout_s — a hiccup mid-wait cannot stretch the
        # call to ~2x the requested bound
        host, port = self._addr
        deadline = time.monotonic() + timeout_s
        state = self.policy.begin()
        while True:
            left = max(0.0, deadline - time.monotonic())
            sent = False
            try:
                with socket.create_connection(
                        (host, port),
                        timeout=left + self._timeout) as s:
                    s.sendall(
                        f"WAIT {kind} {n} "
                        f"{int(left * 1000)}\n".encode())
                    sent = True
                    return s.makefile("r").readline().strip() == "OK"
            except OSError as e:
                if sent and time.monotonic() < deadline:
                    # the request reached the server, so the failure
                    # came AFTER time legitimately spent blocked in the
                    # server-side wait — that time must not be charged
                    # against the policy's (short) failure deadline, or
                    # one hiccup late in a long WAIT aborts instead of
                    # retrying the remaining window
                    state = self.policy.begin()
                state.record(e, what=(f"registry at {host}:{port}: "
                                      "WAIT failed"))
                state.sleep()


class Lease:
    """Holds one registration alive: heartbeats every ttl/3 on a daemon
    thread; `lost` flips when the registry revoked the slot (missed
    heartbeats past the TTL — the reference's lease-expiry signal that
    tells a pserver to exit, go/cmd/pserver/pserver.go:42)."""

    def __init__(self, registry, kind: str, addr: str, ttl_s: float = 3.0,
                 on_lost=None):
        self._reg = registry
        self.kind = kind
        self.addr = addr
        self.ttl_s = ttl_s
        self.index, self._lease = registry.register(kind, addr, ttl_s)
        self.lost = False
        self.released = False
        self._on_lost = on_lost
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        # a cleanly-exiting member frees its slot IMMEDIATELY instead of
        # making the cluster wait out the TTL (and the controller treat
        # a normal exit as a failure); release() is idempotent, so an
        # explicit release beats the hook to it and unregisters it
        atexit.register(self.release)

    def _beat(self):
        while not self._stop.wait(self.ttl_s / 3.0):
            try:
                ok = self._reg.heartbeat(self.kind, self.index, self._lease)
            except OSError:
                continue  # registry unreachable: retry until it answers
            if not ok:  # definitive GONE: the slot was revoked
                self.lost = True
                if self._on_lost is not None:
                    self._on_lost()
                return

    def release(self):
        """Stop heartbeating and free the slot.  Idempotent, and safe
        after the registry is gone (closed handle, dead TCP peer,
        interpreter teardown) — a release can never raise."""
        if self.released:
            return
        self.released = True
        try:
            atexit.unregister(self.release)
        except Exception:  # interpreter teardown ordering
            pass
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=self.ttl_s)
        try:
            self._reg.deregister(self.kind, self.index, self._lease)
        except Exception:
            # OSError (registry unreachable / RetryError) or native
            # teardown artifacts: the TTL reclaims the slot anyway
            pass


def resolve_pserver_cluster(ttl_s: float = 3.0, timeout_s: float = 60.0,
                            exit_on_lost: bool = True):
    """Role-aware cluster resolution for registry-launched pserver jobs
    (paddle_tpu_torch.launch --registry): replaces the static PSERVERS endpoint
    list with TTL-lease discovery (reference go/pserver etcd flow).

    Reads PADDLE_TPU_REGISTRY (+PADDLE_TPU_NUM_PSERVERS, TRAINING_ROLE).
    A PSERVER first BINDS a listening socket (parked for its upcoming
    listen_and_serv via `parallel.pserver.prebind_endpoint` — the port
    is owned continuously from publication to serve, no TOCTOU gap),
    registers the bound address under a kept-alive lease, then everyone
    blocks until the desired count is registered and gets the SAME
    index-ordered endpoint list (the transpiler's param split is
    positional, so order must agree across all processes).

    `exit_on_lost` (pserver role): when the registry revokes the lease
    (heartbeat gap > TTL — the slot may already be re-assigned), the
    process EXITS instead of serving as a zombie with a stale identity,
    matching the reference pserver's lease-expiry crash
    (go/cmd/pserver/pserver.go:42).

    Returns (pservers_csv, my_endpoint_or_None, lease_or_None); falls
    back to the PSERVERS/SERVER_ENDPOINT env convention when no registry
    is configured.
    """
    import os
    import sys

    reg_addr = os.environ.get("PADDLE_TPU_REGISTRY")
    role = os.environ.get("TRAINING_ROLE", "TRAINER")
    if not reg_addr:
        return (os.environ["PSERVERS"],
                os.environ.get("SERVER_ENDPOINT"), None)
    rc = RegistryClient(reg_addr)
    n = int(os.environ["PADDLE_TPU_NUM_PSERVERS"])
    my_ep = None
    lease = None
    if role == "PSERVER":
        from ..parallel.pserver import prebind_endpoint

        my_ep = prebind_endpoint()

        def _lost():
            sys.stderr.write(
                f"pserver {my_ep}: registry lease revoked (heartbeat "
                "gap > TTL); exiting — the slot may already belong to a "
                "replacement\n")
            os._exit(17)

        lease = Lease(rc, "pserver", my_ep, ttl_s=ttl_s,
                      on_lost=_lost if exit_on_lost else None)
    if not rc.wait_ready("pserver", n, timeout_s):
        raise RuntimeError(
            f"registry at {reg_addr}: only "
            f"{len(rc.list('pserver'))}/{n} pservers registered within "
            f"{timeout_s}s — cluster cannot form (fail fast, don't hang)")
    eps = [addr for _, addr in sorted(rc.list("pserver").items())]
    return ",".join(eps), my_ep, lease
