"""TCP front for one GenerationServer process — the replica side of the
multi-replica front door (cloud/router.py).

Wire protocol: one JSON object per line, newline-delimited both ways
(the registry/cluster line-protocol convention, sized for control
traffic — tokens are a few bytes each and generation is compute-bound,
so a text protocol costs nothing measurable):

  {"op":"generate","prompt":[..],"max_new":8,"temperature":0,
   "seed":0,"eos_id":null,"deadline_ms":null,"skip":0}
      -> {"tok":17} per generated token (the first `skip` tokens are
         recomputed but NOT re-sent — the router's resume path after a
         replica death: decode is deterministic per (prompt, seed), so
         the survivor regenerates the same stream and the client never
         sees a duplicate), then {"done":true,"n":<generated>}
      -> {"err":"...","shed":true}  (deadline/saturation shed — a
         POLICY answer, the router must not retry it)
      -> {"err":"...","fatal":true} (caller error, e.g. over-capacity
         request — retrying elsewhere cannot help)
      -> {"err":"..."}              (replica-local failure — the router
         retries on a survivor)
  {"op":"ping"}   -> {"ok":true,"outstanding":N,"free_blocks":F,
                      "draining":false,"warm_start":false}
  {"op":"stats"}  -> {"ok":true,"stats":{...}}
  {"op":"flight"} -> {"ok":true,"dump":{...}}  (the process flight-
                     recorder ring: recent spans/events/metric
                     snapshots, observability/flightrecorder.py)
  {"op":"swap","dir":"..."} -> {"ok":true} after drain+swap+resume
  {"op":"drain","timeout":30} -> {"ok":true,"drained":true} — stop
                     ADMISSION and (by default) wait for every
                     accepted request to finish: the graceful-scale-in
                     verb the autoscaler calls before retiring a
                     replica ({"wait":false} just flips the flag)
  {"op":"resume"} -> {"ok":true} — re-open admission (aborted scale-in)
  {"op":"stop"}   -> {"ok":true}, then the replica shuts down

A replica registers itself in the front door's TTL-lease registry
(kind "generation") and holds the lease for its lifetime: lease expiry
IS the health check — a SIGKILLed replica vanishes from the routing
table within one TTL.  A SIGTERMed replica (scale-in, rolling restart)
dies GRACEFULLY when `install_sigterm()` is armed (`cli serve` does):
stop admission -> release the lease (delist from routing) -> drain
in-flight streams -> delist the telemetry announcement -> exit — the
front door never mistakes a scale-in for a death.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import threading
import time
from typing import Iterator, Optional

from ..core.resilience import fault_injector
from ..observability import tracing as obs_tracing
from .batching import RequestDeadlineExceeded, ServerSaturated

__all__ = ["ReplicaServer", "ReplicaError", "ReplicaShed",
           "replica_call", "replica_stream"]


class ReplicaError(RuntimeError):
    """The replica answered with a non-shed error (`fatal` marks caller
    errors that must not be retried on another replica)."""

    def __init__(self, message: str, fatal: bool = False):
        super().__init__(message)
        self.fatal = fatal


class ReplicaShed(RequestDeadlineExceeded):
    """The replica shed the request (deadline/saturation policy)."""


class ReplicaServer:
    """Serve one GenerationServer over TCP; optionally hold a TTL lease
    in a registry so the router can discover and health-check it."""

    def __init__(self, server, port: int = 0, host: str = "127.0.0.1",
                 registry_addr: Optional[str] = None,
                 kind: str = "generation", ttl_s: float = 2.0,
                 drain_grace_s: float = 30.0,
                 own_announcement: bool = False):
        self._server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self.addr = f"{host}:{self.port}"
        self._stop = threading.Event()
        self._drain_grace_s = float(drain_grace_s)
        self._prev_sigterm = None
        # in-flight generate CONNECTIONS (distinct from the scheduler's
        # active set: the scheduler can be drained while a handler
        # thread is still flushing a stream's tail to a slow client)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._lease = None
        if registry_addr:
            # lazy import: the registry rides the native lib, which a
            # plain in-process server never needs
            from ..cloud.registry import Lease, RegistryClient

            self._lease = Lease(RegistryClient(registry_addr), kind,
                                self.addr, ttl_s=ttl_s)
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()
        # fleet telemetry: with PADDLE_TPU_TELEMETRY_REGISTRY set, the
        # replica publishes its /metrics endpoint for the
        # TelemetryCollector (no-op otherwise).  The announcement is
        # PROCESS-global (maybe_announce returns one shared handle), so
        # a graceful shutdown only delists it when this replica OWNS
        # the process (`cli serve` passes own_announcement=True) — an
        # embedded replica retiring must not remove a still-serving
        # process from the collector's member table.
        from ..observability.collector import maybe_announce

        self._own_announcement = bool(own_announcement)
        self._announcement = maybe_announce(kind)

    # -- server side --------------------------------------------------------
    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def _handle(self, conn: socket.socket):
        try:
            f = conn.makefile("rw", newline="\n")
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except ValueError:
                    self._reply(f, {"err": "malformed request",
                                    "fatal": True})
                    continue
                if not self._dispatch(f, req):
                    break
        except (OSError, ValueError):
            pass  # client went away mid-reply; nothing to deliver
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _reply(f, obj) -> None:
        # default=str: flight dumps carry arbitrary span attrs / note
        # payloads (numpy scalars, exceptions) — the post-mortem path
        # must not die on an unserializable ring entry
        f.write(json.dumps(obj, separators=(",", ":"), default=str)
                + "\n")
        f.flush()

    def _dispatch(self, f, req) -> bool:
        op = req.get("op")
        if op == "generate":
            self._op_generate(f, req)
        elif op == "ping":
            self._reply(f, {
                "ok": True,
                "outstanding": self._server.outstanding_tokens(),
                "free_blocks": self._server._cache.free_blocks,
                "draining": (self._server.draining
                             or self._server._pending_states
                             is not None),
                "warm_start": bool(getattr(self._server,
                                           "warm_start_dir", None))})
        elif op == "stats":
            self._reply(f, {"ok": True, "stats": self._server.stats()})
        elif op == "flight":
            from ..observability import flightrecorder

            self._reply(f, {"ok": True,
                            "dump": flightrecorder.dump_dict(
                                reason="wire")})
        elif op == "swap":
            try:
                fault_injector().fire("serving.replica_swap")
                from .generation import load_generation_model

                states, _, draft_states = load_generation_model(
                    req["dir"], with_draft=True)
                # refresh the draft alongside the target when both
                # sides have one: a stale draft stays correct but its
                # accept rate against the new checkpoint can collapse
                # — a silent throughput regression on every swap
                if getattr(self._server, "_draft", None) is None:
                    draft_states = None
                ok = self._server.swap_states(
                    states, draft_states=draft_states,
                    wait=True, timeout=req.get("timeout", 120))
                self._reply(f, {"ok": bool(ok)})
            except Exception as e:
                self._reply(f, {"err": f"swap failed: {e!r}"})
        elif op == "drain":
            try:
                drained = self._server.drain(
                    wait=bool(req.get("wait", True)),
                    timeout=req.get("timeout", self._drain_grace_s))
                self._reply(f, {"ok": True, "drained": bool(drained),
                                "draining": True})
            except RuntimeError as e:  # already closed
                self._reply(f, {"err": str(e)})
        elif op == "resume":
            try:
                self._server.resume()
                self._reply(f, {"ok": True})
            except Exception as e:
                self._reply(f, {"err": f"resume failed: {e!r}"})
        elif op == "stop":
            self._reply(f, {"ok": True})
            self.close()
            return False
        else:
            self._reply(f, {"err": f"unknown op {op!r}", "fatal": True})
        return True

    def _op_generate(self, f, req):
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._op_generate_inner(f, req)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _op_generate_inner(self, f, req):
        # join the router's trace: the propagated context (riding the
        # request JSON) parents this replica-side span — and, through
        # submit()'s context capture, the generation server's own
        # serving.request span — under the front door's root span, so
        # `cli trace-of` shows one tree across the three processes
        with obs_tracing.activate(
                obs_tracing.extract(req.get("trace"))), \
                obs_tracing.span("replica.generate",
                                 max_new=int(req["max_new"])):
            self._op_generate_traced(f, req)

    def _op_generate_traced(self, f, req):
        try:
            stream = self._server.submit(
                req["prompt"], int(req["max_new"]),
                temperature=float(req.get("temperature", 0.0)),
                seed=int(req.get("seed", 0)),
                eos_id=req.get("eos_id"),
                deadline_ms=req.get("deadline_ms"))
        except ServerSaturated as e:
            self._reply(f, {"err": str(e), "shed": True})
            return
        except ValueError as e:
            # caller error (e.g. over-capacity request): no other
            # replica can serve it either — don't retry
            self._reply(f, {"err": str(e), "fatal": True})
            return
        except RuntimeError as e:
            # replica-local state (server closing mid-accept during a
            # rolling restart): a SURVIVOR can serve this — retryable
            self._reply(f, {"err": str(e)})
            return
        skip = int(req.get("skip", 0))
        n = 0
        try:
            for tok in stream:
                n += 1
                if n > skip:
                    self._reply(f, {"tok": tok})
            self._reply(f, {"done": True, "n": n})
        except RequestDeadlineExceeded as e:
            self._reply(f, {"err": str(e), "shed": True})
        except Exception as e:
            self._reply(f, {"err": repr(e)})

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the replica is stopped (a remote `stop` op or
        close()); the `cli serve` foreground loop."""
        return self._stop.wait(timeout)

    # -- graceful termination (scale-in / SIGTERM) --------------------------
    def install_sigterm(self, grace_s: Optional[float] = None) -> bool:
        """Arm graceful SIGTERM handling, CHAINING onto whatever
        handler is already installed — when the flight recorder is
        armed (PADDLE_TPU_FLIGHT_DIR), its dump-and-redeliver hook
        still runs after the drain, so a terminated replica leaves
        both a clean fleet AND a post-mortem ring.  Main-thread only
        (signal.signal's rule); returns False when it could not be
        installed."""
        if grace_s is not None:
            self._drain_grace_s = float(grace_s)
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        except (ValueError, OSError):  # not the main thread
            self._prev_sigterm = None
            return False
        return True

    def _on_sigterm(self, signum, frame):
        self.shutdown_gracefully(self._drain_grace_s)
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)  # e.g. the flight recorder's dump hook
        elif prev == signal.SIG_IGN:
            return
        else:
            # restore the default disposition and re-deliver so the
            # process still dies OF SIGTERM (exit status intact)
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def shutdown_gracefully(self, grace_s: float = 30.0) -> None:
        """The scale-in exit sequence (docs/serving.md 'Autoscaling'):

        1. stop ADMISSION (new generate ops answer a retryable error,
           so a front-door router resubmits on a survivor);
        2. release the registry lease — the replica delists from the
           routing table immediately instead of looking like a death
           whose TTL expiry trips router retries;
        3. drain: every accepted request runs to completion and its
           handler thread finishes flushing the stream (bounded by
           `grace_s`; whatever is left past the grace is cut off and
           resumed by the router on a survivor — still zero failed);
        4. delist the telemetry announcement (this process's /metrics
           endpoint leaves the collector's member table cleanly);
        5. close the listener.

        Idempotent; called by the SIGTERM chain and usable directly."""
        if self._stop.is_set():
            return
        deadline = time.monotonic() + float(grace_s)
        try:
            self._server.drain(wait=False)
        except RuntimeError:
            pass  # server already closed: nothing to drain
        if self._lease is not None:
            self._lease.release()
        try:
            self._server.drain(
                wait=True, timeout=max(0.0,
                                       deadline - time.monotonic()))
        except RuntimeError:
            pass
        # scheduler drained; let handler threads flush stream tails
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        ann, self._announcement = self._announcement, None
        if ann is not None and self._own_announcement:
            ann.close()
        self.close()

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        if self._lease is not None:
            self._lease.release()
        # shutdown BEFORE close (as the VariableServer does): the
        # accept thread blocked in accept() holds the kernel's open
        # file description, so a bare close() leaves the port
        # LISTENING until one more client connects and gets served by
        # a supposedly-stopped replica — shutdown wakes the accept
        # immediately instead
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never accepted / already gone
        try:
            self._sock.close()
        except OSError:
            pass


# -- client helpers (used by the router and tests) ---------------------------

def _connect(addr: str, timeout_s: float):
    host, port = addr.rsplit(":", 1)
    return socket.create_connection((host, int(port)),
                                    timeout=timeout_s)


def replica_call(addr: str, obj: dict, timeout_s: float = 30.0) -> dict:
    """One request, one JSON reply (ping/stats/swap/stop)."""
    with _connect(addr, timeout_s) as s:
        f = s.makefile("rw", newline="\n")
        f.write(json.dumps(obj, separators=(",", ":")) + "\n")
        f.flush()
        line = f.readline()
        if not line:
            raise OSError(f"replica {addr} closed connection")
        return json.loads(line)


def replica_stream(addr: str, obj: dict,
                   timeout_s: float = 120.0) -> Iterator[int]:
    """Stream a generate request's tokens; raises ReplicaShed on a
    policy shed, ReplicaError on replica-reported failure, OSError when
    the replica dies mid-stream (the router's retry trigger)."""
    with _connect(addr, timeout_s) as s:
        f = s.makefile("rw", newline="\n")
        f.write(json.dumps(obj, separators=(",", ":")) + "\n")
        f.flush()
        while True:
            line = f.readline()
            if not line:
                raise OSError(
                    f"replica {addr} died mid-stream")
            msg = json.loads(line)
            if "tok" in msg:
                yield int(msg["tok"])
            elif msg.get("done"):
                return
            elif "err" in msg:
                if msg.get("shed"):
                    raise ReplicaShed(msg["err"])
                raise ReplicaError(msg["err"],
                                   fatal=bool(msg.get("fatal")))
            else:
                raise ReplicaError(f"unexpected reply {msg!r}")
