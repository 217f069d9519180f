"""Batch-position-keyed dropout in the port, on the CPU.

The JAX package keys each dropout mask row by its global batch row
(`paddle_tpu/ops/activation.py`), and its data-parallel step offsets
each shard's rows (`ctx.row_offset`), so a sharded step draws exactly
the serial masks.  The port draws a counter-based uniform of (the op's
seed, global row, element index) in plain integer ops, with the row
offset carried on `ExecContext` and set by `ParallelExecutor` to rank x
local rows.  Held here, bit for bit: two gloo ranks through the
bucketed overlap step gather the serial Executor's masks (and rank 1's
rows differ from rank 0's); a draw over n rows equals two draws over
its halves at offsets 0 and n/2; `fix_seed` repeats; the draw keeps
each element with probability 1 - p (within 4 sigma).  The JAX
package's threefry bits are not matched: the two agree in distribution.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext
from paddle_tpu_torch.core.registry import get_op_info
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.ops.activation import keyed_uniform_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, STEPS = 16, 2


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


# ROADMAP Queue C's input: x = ones[16, 64] -> dropout(0.5) -> fc(4) ->
# mean softmax-CE, SGD; the worker builds it the same way
_BUILD = r"""
def build(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        d = fluid.layers.dropout(x, dropout_prob=0.5)
        logits = fluid.layers.fc(input=d, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    drop = next(op for op in main.global_block().ops
                if op.type == "dropout")
    return main, startup, loss, drop.output("Mask")[0]


def feeds(steps):
    r = np.random.RandomState(5)
    return [{"x": np.ones((16, 64), np.float32),
             "y": r.randint(0, 4, (16, 1)).astype(np.int64)}
            for _ in range(steps)]
"""

_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
""" + _BUILD + r"""
rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
try:
    main, startup, loss, mask = build(fluid, fw)
    t = fluid.ShardingTranspiler()
    t.transpile(program=main, startup_program=startup, mesh={"dp": 2},
                overlap="bucketed", shard_optimizer_states=False)
    pe = t.build_executor(["x", "y"], [loss, mask],
                          place=fluid.CPUPlace())
    assert pe.overlap_info["mode"] == "bucketed", pe.overlap_info
    out = [pe.run(f) for f in feeds(2)]
    np.savez(out_path, losses=np.array([o[0][0] for o in out]),
             masks=np.stack([o[1] for o in out]))
finally:
    dist.destroy_process_group()
"""

exec(_BUILD)  # build() and feeds() for the serial side


def test_two_gloo_ranks_draw_the_serial_masks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), store,
         str(tmp_path / f"rank{r}.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]

    main, startup, loss, mask = build(tfluid, tfw)
    tfluid.Executor(CPUPlace()).run(startup)
    exe = tfluid.Executor(CPUPlace())     # step 0, as the PE's first run
    serial = [exe.run(main, feed=f, fetch_list=[loss, mask])
              for f in feeds(STEPS)]
    s_masks = np.stack([m for _, m in serial])
    s_losses = np.array([lo[0] for lo, _ in serial])

    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["masks"], s_masks)
    np.testing.assert_allclose(ranks[0]["losses"], s_losses, rtol=1e-6)
    half = ROWS // 2
    for step in range(STEPS):
        m = s_masks[step]
        assert not np.array_equal(m[:half], m[half:]), step
        assert set(np.unique(m)) == {0.0, 1.0}
    # each step draws anew
    assert not np.array_equal(s_masks[0], s_masks[1])


@pytest.mark.parametrize("shape", [(10, 7), (9, 3, 5), (6,)])
def test_a_draw_equals_its_halves_at_their_offsets(shape):
    n = shape[0]
    whole = keyed_uniform_mask(shape, 0.4, 1234, 0, torch.float32, "cpu")
    top = keyed_uniform_mask((n // 2,) + shape[1:], 0.4, 1234, 0,
                             torch.float32, "cpu")
    rest = keyed_uniform_mask((n - n // 2,) + shape[1:], 0.4, 1234, n // 2,
                              torch.float32, "cpu")
    assert torch.equal(whole, torch.cat([top, rest]))
    moved = keyed_uniform_mask(shape, 0.4, 1234, 3, torch.float32, "cpu")
    assert not torch.equal(whole, moved)


def test_the_op_keys_by_the_contexts_row_offset():
    """The op with a context at row offset k draws rows k.. of the draw
    at offset 0 (same seed), whatever the chunking."""
    lower = get_op_info("dropout").lower
    attrs = {**get_op_info("dropout").attrs, "dropout_prob": 0.5}
    x = torch.ones(12, 33)
    full = lower(ExecContext("cpu", seed=77), {"X": [x]}, attrs)["Mask"]
    part = lower(ExecContext("cpu", seed=77, row_offset=5),
                 {"X": [x[:7]]}, attrs)["Mask"]
    assert torch.equal(full[5:], part)
    ctx = ExecContext("cpu", seed=77, row_offset=5)
    assert ctx.child(3).row_offset == ctx.child(3).pure().row_offset == 5


def test_chunked_draw_equals_one_chunk(monkeypatch):
    from paddle_tpu_torch.ops import activation

    want = keyed_uniform_mask((40, 17), 0.3, 9, 2, torch.bfloat16, "cpu")
    monkeypatch.setattr(activation, "_DRAW_CHUNK", 50)   # 2 rows a chunk
    got = keyed_uniform_mask((40, 17), 0.3, 9, 2, torch.bfloat16, "cpu")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_fix_seed_repeats_and_seeds_differ():
    lower = get_op_info("dropout").lower
    base = {**get_op_info("dropout").attrs, "dropout_prob": 0.5}
    x = torch.ones(8, 40)

    def draw(ctx_seed, **attrs):
        return lower(ExecContext("cpu", seed=ctx_seed), {"X": [x]},
                     {**base, **attrs})["Mask"]

    fixed = draw(1, fix_seed=True, seed=7)
    assert torch.equal(fixed, draw(2, fix_seed=True, seed=7))
    assert not torch.equal(fixed, draw(1, fix_seed=True, seed=8))
    assert not torch.equal(draw(1), draw(2))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_four_sigma(p):
    n = 1000 * 1000
    m = keyed_uniform_mask((1000, 1000), p, 2024, 0, torch.float32, "cpu")
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(float(m.mean()) - (1 - p)) <= 4 * sigma
    # neighbouring rows and columns are uncorrelated (4 sigma of 1/sqrt n)
    a = m.numpy()
    for x, y in ((a[:-1], a[1:]), (a[:, :-1], a[:, 1:])):
        c = np.corrcoef(x.ravel(), y.ravel())[0, 1]
        assert abs(c) <= 4 / np.sqrt(x.size), c
