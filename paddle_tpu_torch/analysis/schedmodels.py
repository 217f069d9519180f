"""Protocol models for the deterministic-schedule checker (counterpart
of paddle_tpu/analysis/schedmodels.py).

Each model is a small, faithful re-statement of one of the distributed
runtime's concurrency protocols, written against plain `threading`
primitives so schedcheck.explore() can serialize it and search
interleavings.  They are MODELS, not mocks-of-everything: where the real
state machine is pure host-side Python the real class is used directly
(the GenerationServer model drives this package's real
serving.kv_cache.PagedKVCache, so the KV-block refcount-balance
invariant checks the production accounting, not a toy).

Every model returns a state dict; its paired invariant raises on a bad
terminal state.  `PROTOCOLS` maps protocol name -> (model_factory,
invariant) for the CLI (`cli concurrency --sched`) and CI; each factory
also takes `buggy=True` to reintroduce a characteristic historical bug
shape, which the checker must then FIND — that is tested, so the models
cannot rot into always-green.

Checked invariants:
  * fence_migrate_commit — no deadlock; NO LOST SHARD COPY: every
    placed param has a confirmed holder after COMMIT (buggy=True drops
    the last copy before the new owner confirmed, the shape the
    `owner_ok` check fixed);
  * elastic_round — a mid-round endpoint death is replayed against the
    next view: every grad applied at-least-once, the round terminates
    (buggy=True replays against the STALE view — the round wedges);
  * generation_admit_finish_swap — admit/finish/hot-swap over the REAL
    PagedKVCache keeps KV-BLOCK REFCOUNT BALANCE: after drain +
    flush_prefix the pool is fully free and no live refs remain
    (buggy=True skips release on a finish that lands mid-drain);
  * comm_send_round — two caller threads sharing the pool never
    interleave one endpoint's frames (the per-endpoint worker is what
    serializes them; buggy=True writes to the shared socket directly).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Tuple

__all__ = [
    "PROTOCOLS",
    "model_fence_migrate_commit",
    "invariant_fence_migrate_commit",
    "model_elastic_round",
    "invariant_elastic_round",
    "model_generation_admit_finish_swap",
    "invariant_generation_admit_finish_swap",
    "model_comm_send_round",
    "invariant_comm_send_round",
]


# ---------------------------------------------------------------------------
# FENCE -> MIGRATE -> COMMIT (cloud/cluster.py two-phase rebalance)
# ---------------------------------------------------------------------------


def model_fence_migrate_commit(buggy: bool = False):
    """Pserver B dies holding the only pserver copy of shard "v"; the
    controller fences the survivor, recovers "v" from the trainer-held
    copy, commits a new view.  A trainer keeps running rounds
    throughout, waiting out the fence.

    buggy=True: the trainer-held copy is DISCARDED before the push to
    the new owner is confirmed, while the first push attempt fails —
    the shard is lost for good under the schedule where the failure
    interleaves before the drop (the `owner_ok` bug shape)."""

    def run():
        cond = threading.Condition()
        state = {
            "view": {"epoch": 1, "place": {"w": "A", "v": "B"}},
            "servers": {
                "A": {"fenced": False, "shards": {"w": 10}},
                "B": {"fenced": False, "shards": {"v": 20},
                      "dead": False},
            },
            "trainer_copies": {"v": 20},
            "push_attempts": [0],
            "rounds_done": 0,
            "lost": [],
        }
        servers = state["servers"]

        def push_to_owner(name, value, owner):
            """Trainer-held recovery push; the FIRST attempt fails
            (dead-connection shape the controller must tolerate)."""
            state["push_attempts"][0] += 1
            if state["push_attempts"][0] == 1:
                return False
            with cond:
                servers[owner]["shards"][name] = value
            return True

        def controller():
            with cond:
                servers["B"]["dead"] = True
                state["view"] = {"epoch": 2, "status": "rebalancing",
                                 "place": {"w": "A", "v": "A"}}
                servers["A"]["fenced"] = True
                cond.notify_all()
            # MIGRATE: dead B's shard "v" must land on A.  Source: the
            # trainer-held copy (B is gone, no snapshot in this model).
            copy = state["trainer_copies"].get("v")
            owner_ok = False
            if copy is not None:
                if buggy:
                    # drop the last copy BEFORE the push is confirmed
                    state["trainer_copies"].pop("v", None)
                ok = push_to_owner("v", copy, "A")
                if not ok:
                    # retry against the (still-held) trainer copy —
                    # exactly what the buggy variant just threw away
                    copy2 = state["trainer_copies"].get("v")
                    if copy2 is not None:
                        ok = push_to_owner("v", copy2, "A")
                owner_ok = ok and "v" in servers["A"]["shards"]
            if not owner_ok:
                state["lost"].append("v")
            if not buggy:
                state["trainer_copies"].pop("v", None)
            # COMMIT
            with cond:
                servers["A"]["fenced"] = False
                state["view"] = {"epoch": 3, "status": "stable",
                                 "place": {"w": "A", "v": "A"}}
                cond.notify_all()

        def trainer():
            for _ in range(2):
                while True:
                    with cond:
                        view = state["view"]
                        owner = view["place"]["w"]
                        if servers[owner].get("dead") \
                                or servers[owner]["fenced"]:
                            # fenced/dead: wait for the next view
                            cond.wait()
                            continue
                        servers[owner]["shards"]["w"] += 1
                        state["rounds_done"] += 1
                        break

        ts = [threading.Thread(target=controller),
              threading.Thread(target=trainer)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return state

    return run


def invariant_fence_migrate_commit(state):
    assert not state["lost"], f"lost shard copies: {state['lost']}"
    view = state["view"]
    assert view["status"] == "stable", view
    for name, owner in view["place"].items():
        assert name in state["servers"][owner]["shards"], \
            f"{name} not held by its placed owner {owner}"
    assert state["rounds_done"] == 2, state["rounds_done"]


# ---------------------------------------------------------------------------
# elastic_round retry/replay (parallel/comm.py)
# ---------------------------------------------------------------------------


def model_elastic_round(buggy: bool = False):
    """Endpoint A dies mid-round; the trainer must forget its conns,
    wait for a FRESH stable view, and replay the whole round against
    the new placement.  buggy=True replays against the view it already
    has (the pre-elastic_round shape): the round retries into the dead
    endpoint forever — bounded here by an attempt cap, surfacing as a
    round that never completes."""

    def run():
        cond = threading.Condition()
        state = {
            "view": {"epoch": 1, "place": {"g0": "A", "g1": "B"}},
            "endpoints": {"A": {"dead": False, "applied": []},
                          "B": {"dead": False, "applied": []}},
            "round_ok": False,
            "attempts": 0,
        }

        def send(ep, grad):
            e = state["endpoints"][ep]
            if e["dead"]:
                raise ConnectionError(f"{ep} is dead")
            e["applied"].append(grad)

        def killer():
            with cond:
                state["endpoints"]["A"]["dead"] = True
                cond.notify_all()

        def controller():
            # publishes the post-death view once A is observed dead
            with cond:
                while not state["endpoints"]["A"]["dead"]:
                    cond.wait()
                state["view"] = {"epoch": 2,
                                 "place": {"g0": "B", "g1": "B"}}
                cond.notify_all()

        def trainer():
            with cond:
                view = state["view"]
            for _ in range(6):              # attempt cap
                state["attempts"] += 1
                try:
                    for grad, ep in sorted(view["place"].items()):
                        send(ep, grad)
                    state["round_ok"] = True
                    return
                except ConnectionError:
                    if buggy:
                        continue            # replay the STALE view
                    with cond:
                        epoch = view["epoch"]
                        while state["view"]["epoch"] <= epoch:
                            cond.wait()
                        view = state["view"]

        ts = [threading.Thread(target=killer),
              threading.Thread(target=controller),
              threading.Thread(target=trainer)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return state

    return run


def invariant_elastic_round(state):
    assert state["round_ok"], \
        f"round never completed ({state['attempts']} attempts)"
    applied = (state["endpoints"]["A"]["applied"]
               + state["endpoints"]["B"]["applied"])
    # at-least-once: every grad applied somewhere (replays may double)
    for g in ("g0", "g1"):
        assert g in applied, f"{g} never applied: {applied}"


# ---------------------------------------------------------------------------
# GenerationServer admit/finish/hot-swap over the REAL PagedKVCache
# ---------------------------------------------------------------------------


def model_generation_admit_finish_swap(buggy: bool = False):
    """The serving scheduler's slot protocol against the production
    KV-cache accounting: FIFO admission gated on free blocks, per-tick
    cursor advance with prefix commit, release on finish, and a hot
    swap (pause admission -> drain -> install -> resume) racing the
    whole thing.  buggy=True drops the release() for a sequence whose
    finish lands while the swap is draining — the eviction-leak
    shape; the pool never returns to full."""

    def run():
        from ..serving.kv_cache import KVPoolExhausted, PagedKVCache

        cache = PagedKVCache(6, block_size=2, max_blocks_per_seq=4,
                             prefix_cache=True,
                             server_label="schedmodel")
        cond = threading.Condition()
        state = {
            "cache": cache,
            # (owner-id, prompt tokens, total positions needed)
            "queue": [("r1", [1, 2, 3, 4], 6),
                      ("r2", [1, 2, 3, 4], 6),   # shares r1's prefix
                      ("r3", [7, 8], 4)],
            "active": {},        # owner -> cursor/need
            "finished": [],
            "swap": {"pending": False, "installed": 0},
            "stop": False,
        }

        def scheduler():
            while True:
                with cond:
                    while True:
                        if (not state["queue"]
                                and not state["active"]
                                and not state["swap"]["pending"]
                                and state["swap"]["installed"]):
                            # drained AND the announced swap landed
                            # (exiting before the swapper even set
                            # `pending` would strand it — the checker
                            # found exactly that in an earlier draft)
                            return
                        # hot swap: admission paused; drain actives
                        if state["swap"]["pending"] \
                                and not state["active"]:
                            cache.flush_prefix()
                            state["swap"]["installed"] += 1
                            state["swap"]["pending"] = False
                            cond.notify_all()
                            continue   # re-check exit from the top
                        admitted = False
                        while (state["queue"]
                               and not state["swap"]["pending"]
                               and len(state["active"]) < 2):
                            owner, prompt, need = state["queue"][0]
                            if not cache.can_admit(
                                    need, prompt_tokens=prompt):
                                break
                            try:
                                table, cached = cache.allocate_prefix(
                                    owner, need, prompt_tokens=prompt)
                            except KVPoolExhausted:
                                break
                            state["queue"].pop(0)
                            state["active"][owner] = {
                                "cursor": cached, "need": need,
                                "prompt": prompt}
                            admitted = True
                        if state["active"] or admitted:
                            break
                        # queued work we cannot admit yet (or a swap
                        # waiting on actives): let other threads move
                        cond.wait()
                # one decode tick outside the admission lock (the real
                # scheduler dispatches the decode step here)
                with cond:
                    done = []
                    for owner, seq in state["active"].items():
                        seq["cursor"] += 1
                        cache.commit_prefix(owner, seq["cursor"])
                        if seq["cursor"] >= seq["need"]:
                            done.append(owner)
                    for owner in done:
                        state["active"].pop(owner)
                        leak = (buggy and state["swap"]["pending"])
                        if not leak:
                            cache.release(owner)
                        state["finished"].append(owner)
                    cond.notify_all()

        def swapper():
            with cond:
                state["swap"]["pending"] = True
                cond.notify_all()
                while state["swap"]["pending"]:
                    cond.wait()

        ts = [threading.Thread(target=scheduler),
              threading.Thread(target=swapper)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return state

    return run


def invariant_generation_admit_finish_swap(state):
    cache = state["cache"]
    assert sorted(state["finished"]) == ["r1", "r2", "r3"], \
        state["finished"]
    assert state["swap"]["installed"] == 1, state["swap"]
    # KV-block refcount balance: after drain + flush, the pool is
    # whole again and no live references remain
    cache.flush_prefix()
    assert cache.free_blocks == cache.num_blocks, (
        f"leaked KV blocks: {cache.num_blocks - cache.free_blocks} "
        "still resident after drain")
    assert not cache._ref, f"dangling refcounts: {cache._ref}"
    assert not cache._owned, f"dangling owners: {list(cache._owned)}"
    cache.close()


# ---------------------------------------------------------------------------
# CommPool.send_round per-endpoint ordering (parallel/comm.py)
# ---------------------------------------------------------------------------


def model_comm_send_round(buggy: bool = False):
    """Two caller threads run a fused round over the same two
    endpoints.  The pool's contract: each endpoint's wire sees one
    round's frame chain (sends -> barrier -> get) CONTIGUOUSLY,
    because only that endpoint's single worker touches its socket.
    buggy=True has callers write the shared socket directly — an
    interleaving the checker must find."""

    def run():
        wires: Dict[str, list] = {"ep_a": [], "ep_b": []}
        workers: Dict[str, queue.Queue] = {}
        threads = []
        stop = object()

        def worker(ep, q):
            while True:
                task = q.get()
                if task is stop:
                    return
                fn, done = task
                fn()
                done.set()

        for ep in wires:
            q = queue.Queue()
            workers[ep] = q
            t = threading.Thread(target=worker, args=(ep, q))
            t.start()
            threads.append(t)

        def frame_chain(caller, ep):
            # the per-endpoint chain; a yield point between frames is
            # implicit in the queue/lock operations around this, and
            # the buggy path interleaves exactly there
            from . import schedcheck

            for frame in ("send", "barrier", "get"):
                wires[ep].append((caller, frame))
                schedcheck.yield_point("wire-frame")

        def send_round(caller):
            if buggy:
                for ep in sorted(wires):
                    frame_chain(caller, ep)
                return
            dones = []
            for ep in sorted(wires):
                done = threading.Event()
                workers[ep].put(
                    (lambda c=caller, e=ep: frame_chain(c, e), done))
                dones.append(done)
            for done in dones:
                done.wait()

        callers = [threading.Thread(target=send_round, args=(c,))
                   for c in ("t1", "t2")]
        for t in callers:
            t.start()
        for t in callers:
            t.join()
        for q in workers.values():
            q.put(stop)
        for t in threads:
            t.join()
        return wires

    return run


def invariant_comm_send_round(wires):
    for ep, frames in wires.items():
        assert len(frames) == 6, (ep, frames)
        # contiguous per caller: caller runs of exactly 3
        callers = [c for c, _ in frames]
        assert callers[0] == callers[1] == callers[2] and \
            callers[3] == callers[4] == callers[5], (
                f"{ep}: rounds interleaved on one socket: {frames}")
        chain = [f for _, f in frames]
        assert chain == ["send", "barrier", "get"] * 2, (ep, frames)


PROTOCOLS: Dict[str, Tuple[Callable[..., Callable], Callable]] = {
    "fence_migrate_commit": (model_fence_migrate_commit,
                             invariant_fence_migrate_commit),
    "elastic_round": (model_elastic_round, invariant_elastic_round),
    "generation_admit_finish_swap": (
        model_generation_admit_finish_swap,
        invariant_generation_admit_finish_swap),
    "comm_send_round": (model_comm_send_round,
                        invariant_comm_send_round),
}
