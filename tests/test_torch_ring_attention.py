"""The port's ring and Ulysses attention against the JAX package, on the
CPU.

One spawn of 2 and one of 4 gloo ranks, the 'sp' axis as wide as the
world: `ring_attention` and `all_to_all_attention` (parallel/
ring_attention.py) on the same seeded [2, 16, 4, 8] inputs, causal and
full, forward and the gradients of <out, cotangent> with respect to q,
k and v, against the JAX package's functions on the conftest's virtual
devices, within 1e-5 relative and 1e-6 absolute (float32), on every
rank; and both against `attention_reference`.
"""
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel import make_mesh as jmake_mesh

# the modules (the packages export functions of the same name)
jra = importlib.import_module("paddle_tpu.parallel.ring_attention")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 16, 4, 8)
FORMS = ("ring", "ulysses")


def _inputs():
    r = np.random.RandomState(7)
    return [r.randn(*SHAPE).astype(np.float32) for _ in range(4)]


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from paddle_tpu_torch.parallel import make_mesh
import importlib
ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, in_path, out_path = sys.argv[3:6]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
q, k, v, ct = (torch.from_numpy(a) for a in np.load(in_path).values())
mesh = make_mesh({"sp": world})
out = {}
try:
    for form, fn in (("ring", ra.ring_attention),
                     ("ulysses", ra.all_to_all_attention)):
        for causal in (False, True):
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            o = fn(qs, ks, vs, mesh, "sp", causal=causal)
            (o * ct).sum().backward()
            key = f"{form}.{int(causal)}"
            out[key + ".out"] = o.detach().numpy()
            for n, t in (("dq", qs), ("dk", ks), ("dv", vs)):
                out[key + "." + n] = t.grad.numpy()
finally:
    dist.destroy_process_group()
np.savez(out_path, **out)
"""


def _jax(world):
    """{form.causal.{out,dq,dk,dv}} of the JAX package's functions."""
    q, k, v, ct = (jnp.asarray(a) for a in _inputs())
    mesh = jmake_mesh({"sp": world}, devices=jax.devices()[:world])
    res = {}
    for form, fn in (("ring", jra.ring_attention),
                     ("ulysses", jra.all_to_all_attention)):
        for causal in (False, True):
            def f(a, b, c):
                return fn(a, b, c, mesh, "sp", causal=causal)

            o, vjp = jax.vjp(jax.jit(f), q, k, v)
            grads = vjp(ct)
            key = f"{form}.{int(causal)}"
            res[key + ".out"] = np.asarray(o)
            for n, g in zip(("dq", "dk", "dv"), grads):
                res[key + "." + n] = np.asarray(g)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(world):
        if world in cache:
            return cache[world]
        tmp = tmp_path_factory.mktemp(f"ring{world}")
        np.savez(tmp / "in.npz", *_inputs())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(world),
             str(tmp / "store"), str(tmp / "in.npz"),
             str(tmp / f"rank{r}.npz")], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log[-3000:]
        cache[world] = (_jax(world), [dict(np.load(tmp / f"rank{r}.npz"))
                                      for r in range(world)])
        return cache[world]
    return get


_CASES = [(w, f, c) for w in (2, 4) for f in FORMS for c in (0, 1)]


@pytest.mark.parametrize("world,form,causal", _CASES,
                         ids=[f"world{w}-{f}-{'causal' if c else 'full'}"
                              for w, f, c in _CASES])
def test_sequence_parallel_attention_is_the_jax_packages(runs, world, form,
                                                         causal):
    want, ranks = runs(world)
    key = f"{form}.{causal}"
    q, k, v, _ = _inputs()
    ref = np.asarray(jra.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=bool(causal)))
    for r, got in enumerate(ranks):
        for part in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[f"{key}.{part}"],
                                       want[f"{key}.{part}"], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"rank {r} {part}")
        np.testing.assert_allclose(got[f"{key}.out"], ref, rtol=1e-5,
                                   atol=1e-6)
