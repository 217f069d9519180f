"""A3's layer rest against the JAX package: layers.mul, layers.auc,
nets.glu, WeightNormParamAttr with LayerHelper's weight-norm path,
initializer.init_on_cpu / force_init_on_cpu and kernels.registry.select.

Each case builds its Program in both packages under reset unique names;
main and startup Programs must be equal by ``to_dict()`` (ops, slots,
attrs, vars).  The port then runs from the JAX startup's values (copied
into its scope) and must fetch the JAX package's forward values and
gradients (float32 within rtol 1e-5, atol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu import initializer as jinit
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch.core import flags as tflags

RTOL, ATOL = 1e-5, 1e-6
R = np.random.RandomState(3)
_P = R.uniform(0.0, 1.0, (64, 1))
FEED = {"x": R.uniform(-1.0, 1.0, (4, 6)).astype(np.float32),
        "y": R.uniform(-1.0, 1.0, (6, 3)).astype(np.float32),
        "z": R.standard_normal((2, 4, 6)).astype(np.float32),
        "score": np.concatenate([1.0 - _P, _P], axis=1).astype(np.float32),
        "label": (R.uniform(0.0, 1.0, (64, 1)) > 0.4).astype(np.int64)}


@pytest.fixture(autouse=True)
def _fresh_port_flags():
    tflags.reset_flags()
    yield
    tflags.reset_flags()


def _data(fluid, name, grad=True):
    v = FEED[name]
    return fluid.layers.data(name=name, shape=list(v.shape),
                             dtype=str(v.dtype), append_batch_size=False,
                             stop_gradient=not grad)


def _mul(fluid):
    x, y, z = _data(fluid, "x"), _data(fluid, "y"), _data(fluid, "z")
    outs = [fluid.layers.mul(x, y),
            fluid.layers.mul(z, y, x_num_col_dims=2)]
    return outs, [x, y, z]


def _auc(fluid):
    score = _data(fluid, "score", grad=False)
    label = _data(fluid, "label", grad=False)
    return [fluid.layers.auc(input=score, label=label),
            fluid.layers.auc(input=score, label=label,
                             num_thresholds=50)], []


def _glu(fluid):
    x, z = _data(fluid, "x"), _data(fluid, "z")
    return [fluid.nets.glu(x), fluid.nets.glu(z, dim=1)], [x, z]


def _weight_norm(fluid):
    x = _data(fluid, "x")
    outs = [fluid.layers.fc(
        input=x, size=3, param_attr=fluid.WeightNormParamAttr(
            dim=1, name="wn")),
        fluid.layers.fc(input=x, size=5,
                        param_attr=fluid.WeightNormParamAttr(name="wn2"))]
    return outs, [x]


def _init_on_cpu(fluid):
    init = jinit if fluid is jfluid else tinit
    x = _data(fluid, "x")
    with init.init_on_cpu():
        h = fluid.layers.fc(input=x, size=4)
        with init.init_on_cpu():
            h = fluid.layers.fc(input=h, size=3)
        assert init.force_init_on_cpu()
    assert not init.force_init_on_cpu()
    return [fluid.layers.fc(input=h, size=2)], [x]


CASES = {f.__name__[1:]: f for f in (_mul, _auc, _glu, _weight_norm,
                                     _init_on_cpu)}


def _build(fluid, fw, case):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        outs, wrt = CASES[case](fluid)
        grads = []
        if wrt:
            loss = fluid.layers.mean(outs[0])
            for o in outs[1:]:
                loss = fluid.layers.elementwise_add(
                    loss, fluid.layers.mean(o))
            params = [p.name for p in main.global_block().all_parameters()]
            fluid.backward.append_backward(loss)
            grads = [v.name + "@GRAD" for v in wrt] + \
                [p + "@GRAD" for p in params]
    return main, startup, outs, grads


def _int_as_int32(d):
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_rest_builds_and_runs_as_the_jax_packages(case):
    jm, js, jouts, jgrads = _build(jfluid, jfw, case)
    tm, ts, touts, tgrads = _build(tfluid, tfw, case)
    assert _int_as_int32(tm.to_dict()) == _int_as_int32(jm.to_dict())
    assert _int_as_int32(ts.to_dict()) == _int_as_int32(js.to_dict())
    assert tgrads == jgrads
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    for v in js.global_block().vars.values():
        if v.persistable and jscope.has_var(v.name):
            tscope.set_var(v.name, torch.from_numpy(
                np.array(jscope.find_var(v.name))))
    feed = {n: FEED[n] for n in FEED
            if jm.global_block().has_var(n)}
    jv = jexe.run(jm, feed=dict(feed), fetch_list=jouts + jgrads,
                  scope=jscope)
    tv = texe.run(tm, feed=dict(feed), fetch_list=touts + tgrads,
                  scope=tscope)
    names = [o.name for o in touts] + tgrads
    for n, a, b in zip(names, tv, jv):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=n)


def test_weight_norm_startup_sets_g_to_the_norm_of_v():
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        _weight_norm(tfluid)
    assert [w.name for w in main.params_with_weight_norm] == ["wn", "wn2"]
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    v, g = scope.find_var("wn.w_v"), scope.find_var("wn.w_g")
    torch.testing.assert_close(g, torch.sqrt((v * v).sum(0)),
                               rtol=RTOL, atol=ATOL)
    v2, g2 = scope.find_var("wn2.w_v"), scope.find_var("wn2.w_g")
    torch.testing.assert_close(g2.reshape(()),
                               torch.sqrt((v2 * v2).sum()),
                               rtol=RTOL, atol=ATOL)
    assert tfluid.WeightNormParamAttr(dim=0)["weight_norm_dim"] == 0
    assert tfluid.param_attr.WeightNormParamAttr.params_with_weight_norm \
        == []


def test_init_on_cpu_marks_initializer_ops_and_restores_state():
    assert not tinit.force_init_on_cpu()
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = _data(tfluid, "x")
        with tinit.init_on_cpu():
            tfluid.layers.fc(input=x, size=4)
        tfluid.layers.fc(input=x, size=4)
    flags = [op.attrs["force_cpu"] for op in startup.global_block().ops]
    # weight + bias of the first fc inside, of the second outside
    assert flags == [True, True, False, False]
    with pytest.raises(RuntimeError):
        with tinit.init_on_cpu():
            raise RuntimeError("leaves the context")
    assert not tinit.force_init_on_cpu()


def test_kernel_registry_select_is_the_one_off_pick():
    from paddle_tpu.kernels import registry as jreg
    from paddle_tpu_torch.core.flags import get_flag, set_flags
    from paddle_tpu_torch.kernels import registry as treg

    assert "select" in treg.__all__ and "select" in jreg.__all__
    ctx = dict(d_model=64, n_heads=4, block_size=16, max_blocks_per_seq=4,
               kv_dtype="fp32")
    # disarmed on the CPU in both packages: the plain path, uncounted
    assert treg.select("paged_attention_decode", platform="cpu",
                       **ctx) is None
    assert jreg.select("paged_attention_decode", platform="cpu",
                       **ctx) is None
    fam = treg._M_FALLBACKS.labels(kernel="paged_attention_decode",
                                   reason="no_cuda")
    before = fam.value
    prev = get_flag("serving_kernels")
    set_flags({"serving_kernels": "on"})
    try:
        assert treg.select("paged_attention_decode", platform="cpu",
                           **ctx) is None
        assert fam.value == before + 1
    finally:
        set_flags({"serving_kernels": prev})
    with pytest.raises(KeyError):
        treg.select("no_such_kernel", platform="cuda")
