"""The generation builders (`build_lm_generator`, `build_lm_kv_decoder`,
`build_translate_generator`, `build_lm_beam_search`) and `program_to_fn`
in the port against the JAX package's, on the CPU.

Each builder is built in both packages at a test width under reset
unique names (same parameter names), and run on the same parameters:
seeded normal draws with a wide spread, so the next-token choices are
decisive (the startup's 0.02-scale embeddings make near-uniform
softmaxes whose argmax is a coin toss between libraries).  Greedy ids
must be equal, beam ids equal and beam scores within 1e-5, and the
kv decoder equal to the full forward token for token.  Sampling cannot
match jax.random bit for bit: at a fixed temperature the port's draws
are held by distribution against the softmax they sample.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core.executor import program_to_fn as jprogram_to_fn
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import transformer as ttr

V, LEN, D, H, NL = 23, 12, 32, 2, 2
CPU = CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


def _both(name, *args, **kw):
    """The builder `name` in both packages -> ((startup, fn) JAX,
    (startup, fn) port)."""
    jfw.reset_unique_names()
    j = getattr(jtr, name)(*args, **kw)
    tfw.reset_unique_names()
    t = getattr(ttr, name)(*args, place=CPU, **kw)
    return j, t


def _states(startup, names, seed=0, spread=0.5):
    """Seeded parameters for `names`, shaped as the JAX startup makes
    them; layer-norm scales stay near 1."""
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    out = {}
    for n in sorted(names):
        shape = np.asarray(scope.find_var(n)).shape
        v = rng.normal(0.0, spread, shape).astype(np.float32)
        if "layer_norm" in n and n.endswith(".w_0"):
            v = (1.0 + 0.1 * v).astype(np.float32)
        out[n] = v
    return out


def _prompt(b, p, seed=1):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(
        np.int64)


def test_program_to_fn_equals_executor_run():
    """A training Program as a function: fetches and new states equal
    the Executor's run of the same Program from the same state, and
    read-only states pass through."""
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(input=h, size=1), y))
        tfluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    exe = tfluid.Executor(CPU)
    scope = Scope()
    exe.run(startup, scope=scope)
    fn = texecutor.program_to_fn(main, ["x", "y"], [loss], place=CPU)
    assert fn.state_out_names and set(fn.state_out_names) <= set(
        fn.state_in_names)
    states = {n: scope.find_var(n).clone() for n in fn.state_in_names}
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = {"x": rng.rand(4, 6).astype(np.float32),
                "y": rng.rand(4, 1).astype(np.float32)}
        want, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        fetches, states = fn(feed, states)
        np.testing.assert_array_equal(fetches[loss.name].numpy(), want)
        for n in fn.state_in_names:
            assert torch.equal(states[n], scope.find_var(n)), n
    # the JAX package's function names the same states
    jfw.reset_unique_names()
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()):
        jx = jfluid.layers.data(name="x", shape=[6], dtype="float32")
        jy = jfluid.layers.data(name="y", shape=[1], dtype="float32")
        jh = jfluid.layers.fc(input=jx, size=8, act="relu")
        jl = jfluid.layers.mean(jfluid.layers.square_error_cost(
            jfluid.layers.fc(input=jh, size=1), jy))
        jfluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(jl)
        jfn = jprogram_to_fn(jfluid.default_main_program(), ["x", "y"],
                             [jl.name])
    assert jfn.state_in_names == fn.state_in_names
    assert jfn.state_out_names == fn.state_out_names
    assert sorted(jfn.donation_plan.feeds) == sorted(fn.donation_plan.feeds)


def test_lm_generator_greedy_ids_equal_the_jax_package():
    (js, jgen), (_, tgen) = _both("build_lm_generator", V, LEN, d_model=D,
                                  n_heads=H, n_layers=NL)
    assert tgen.state_names == jgen.state_names
    states = _states(js, jgen.state_names)
    prompt = _prompt(3, 3)
    want = np.asarray(jgen(states, prompt.astype(np.int32), num_steps=7))
    got = tgen(states, prompt, num_steps=7).numpy()
    np.testing.assert_array_equal(got, want)


def test_kv_decoder_equals_the_jax_package_and_the_full_forward():
    (js, jkv), (_, tkv) = _both("build_lm_kv_decoder", V, LEN, d_model=D,
                                n_heads=H, n_layers=NL)
    tfw.reset_unique_names()
    _, tfull = ttr.build_lm_generator(V, LEN, d_model=D, n_heads=H,
                                      n_layers=NL, place=CPU)
    assert tkv.state_names == jkv.state_names == sorted(tfull.state_names)
    assert tkv.state_shapes == jkv.state_shapes
    states = _states(js, jkv.state_names)
    prompt = _prompt(3, 4)
    want = np.asarray(jkv(states, prompt.astype(np.int32), num_steps=8))
    got = tkv(states, prompt, num_steps=8).numpy()
    np.testing.assert_array_equal(got, want)
    full = tfull(states, prompt, num_steps=8).numpy()
    np.testing.assert_array_equal(got, full)


def test_translate_generator_equals_the_jax_package():
    S, T = 6, 8
    (js, jtr_), (_, ttr_) = _both("build_translate_generator", V, V, S, T,
                                  d_model=D, n_heads=H, n_layers=1,
                                  bos_id=0, eos_id=1)
    assert ttr_.state_names == jtr_.state_names
    states = _states(js, jtr_.state_names, seed=3)
    src = np.random.RandomState(2).randint(2, V, (4, S)).astype(np.int64)
    want = np.asarray(jtr_(states, src.astype(np.int32), num_steps=T - 1))
    got = ttr_(states, src, num_steps=T - 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all()
    # a row that emitted eos keeps emitting it
    for row in got:
        hit = np.flatnonzero(row[1:] == 1)
        if hit.size:
            assert (row[1 + hit[0]:] == 1).all()


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_search_equals_the_jax_package(beam):
    (js, jbs), (_, tbs) = _both("build_lm_beam_search", V, LEN,
                                beam_size=beam, d_model=D, n_heads=H,
                                n_layers=1)
    assert tbs.state_names == jbs.state_names
    states = _states(js, jbs.state_names, seed=5)
    prompt = _prompt(2, 3, seed=6)
    j_ids, j_sc = jbs(states, prompt.astype(np.int32), num_steps=6)
    t_ids, t_sc = tbs(states, prompt, num_steps=6)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-5,
                               atol=1e-5)
    assert (np.diff(t_sc.numpy(), axis=1) <= 1e-6).all()


def test_beam_ties_go_to_the_lower_index():
    """lax.top_k's order among equal scores: the lower index first."""
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5]])
    vals, idx = ttr._top_k_lowest_first(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0]]
    assert vals.tolist() == [[2.0, 2.0, 2.0, 0.5]]


def test_sampling_follows_the_softmax_at_a_fixed_temperature():
    """The generator's first sampled token over many rows of one prompt:
    its frequencies match softmax(log p / T) of the forward's
    probabilities (chi-square), a fixed seed repeats the draw and
    another seed changes it."""
    tfw.reset_unique_names()
    startup, gen = ttr.build_lm_generator(V, LEN, d_model=D, n_heads=H,
                                          n_layers=1, place=CPU)
    tfw.reset_unique_names()
    js, jgen = jtr.build_lm_generator(V, LEN, d_model=D, n_heads=H,
                                      n_layers=1)
    states = _states(js, jgen.state_names, seed=7, spread=0.1)
    rows, temp = 4000, 0.7
    prompt = np.tile(_prompt(1, 2, seed=8), (rows, 1))
    ids = gen(states, prompt, num_steps=1, temperature=temp, seed=11)
    again = gen(states, prompt, num_steps=1, temperature=temp, seed=11)
    other = gen(states, prompt, num_steps=1, temperature=temp, seed=12)
    assert torch.equal(ids, again) and not torch.equal(ids, other)
    probs = gen.forward({"gen_ids": ids[:1]}, {
        n: torch.as_tensor(v) for n, v in states.items()})[0]
    p = torch.softmax(torch.log(next(iter(probs.values()))[0, 1] + 1e-9)
                      / temp, dim=-1).double().numpy()
    counts = np.bincount(ids[:, 2].numpy(), minlength=V)
    expect = rows * p
    keep = expect >= 5
    chi2 = (((counts[keep] - expect[keep]) ** 2) / expect[keep]).sum()
    # 99.9th percentile of chi-square at <= 22 degrees of freedom: 48.3
    assert chi2 < 48.3, (chi2, counts, expect)


def test_kv_sampling_follows_the_softmax():
    tfw.reset_unique_names()
    _, tkv = ttr.build_lm_kv_decoder(V, LEN, d_model=D, n_heads=H,
                                     n_layers=1, place=CPU)
    tfw.reset_unique_names()
    js, jgen = jtr.build_lm_generator(V, LEN, d_model=D, n_heads=H,
                                      n_layers=1)
    tfw.reset_unique_names()
    _, tfull = ttr.build_lm_generator(V, LEN, d_model=D, n_heads=H,
                                      n_layers=1, place=CPU)
    states = _states(js, jgen.state_names, seed=9, spread=0.1)
    rows, temp = 4000, 1.3
    prompt = np.tile(_prompt(1, 3, seed=10), (rows, 1))
    ids = tkv(states, prompt, num_steps=1, temperature=temp, seed=3)
    probs = tfull.forward({"gen_ids": ids[:1]}, {
        n: torch.as_tensor(v) for n, v in states.items()})[0]
    logits = torch.log(next(iter(probs.values()))[0, 2])
    p = torch.softmax(logits / temp, dim=-1).double().numpy()
    counts = np.bincount(ids[:, 3].numpy(), minlength=V)
    expect = rows * p
    keep = expect >= 5
    chi2 = (((counts[keep] - expect[keep]) ** 2) / expect[keep]).sum()
    assert chi2 < 48.3, (chi2, counts, expect)
