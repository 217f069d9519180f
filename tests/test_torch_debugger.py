"""The port's debugger (program_to_code, print_program,
draw_block_graphviz) against the JAX package's: the same Program built
in both packages gives the same pseudo-code text and the same .dot file,
with and without sub-blocks (tests/test_debugger.py's 3 cases), and
with the verifier's annotations (`diagnostics=`, `verify=True`).

One deliberate difference: the JAX package runs with x64 off, so its
shape inference types an int64 value int32 (the `while` program's
counters), where the port keeps int64; the texts are compared with the
port's int64 read as int32.
"""
import os

import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu.debugger import draw_block_graphviz as jdraw
from paddle_tpu.debugger import program_to_code as jcode
from paddle_tpu_torch.debugger import (draw_block_graphviz, print_program,
                                       program_to_code)


def _fc_program(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.SGD(learning_rate=0.1).minimize(loss)
    return main, loss


def _while_program(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=3)
        cond = fluid.layers.less_than(i, n)
        w = fluid.layers.While(cond)
        with w.block():
            fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    return main


def test_program_to_code_matches_the_jax_package(capsys):
    main, loss = _fc_program(tfluid, tfw)
    code = program_to_code(main)
    assert code == jcode(_fc_program(jfluid, jfw)[0])
    assert "// block 0" in code
    for frag in ("mul(", "sgd(", loss.name, "param "):
        assert frag in code, f"missing {frag!r} in:\n{code[:400]}"
    for op in main.global_block().ops:
        assert f"{op.type}(" in code
    assert program_to_code(main, skip_vars=True) == jcode(
        _fc_program(jfluid, jfw)[0], skip_vars=True)
    print_program(main)
    assert capsys.readouterr().out == code + "\n"


def _x64_off(text):
    return text.replace("dtype=int64", "dtype=int32")


def test_program_to_code_sub_blocks_match_the_jax_package():
    code = program_to_code(_while_program(tfluid, tfw))
    assert "dtype=int64" in code
    assert _x64_off(code) == jcode(_while_program(jfluid, jfw))
    assert "// block 1" in code and "while(" in code
    assert "// -> sub_block" in code


def test_draw_block_graphviz_matches_the_jax_package(tmp_path):
    main, _ = _fc_program(tfluid, tfw)
    path = os.path.join(tmp_path, "block.dot")
    dot = draw_block_graphviz(main.global_block(), path=path,
                              highlights={"x"})
    jpath = os.path.join(tmp_path, "jax_block.dot")
    jdraw(_fc_program(jfluid, jfw)[0].global_block(), path=jpath,
          highlights={"x"})
    assert open(path).read() == open(jpath).read() == dot
    assert dot.startswith("digraph G {") and dot.rstrip().endswith("}")
    assert "fillcolor=\"lightgrey\"" in dot
    assert "shape=box" in dot and "->" in dot and 'color="red"' in dot
    # one op node per op
    assert dot.count("shape=box") == len(main.global_block().ops)


def test_diagnostics_raise_naming_a12():
    """A12's analysis is ported: the verifier's annotations render as the
    JAX package's do (the test keeps its name; nothing raises now)."""
    main, _ = _fc_program(tfluid, tfw)
    jmain = _fc_program(jfluid, jfw)[0]

    def flagged(code):      # the annotation lines' severities and passes
        return [line.split(":")[0].strip() for line in code.splitlines()
                if "// !!" in line]

    assert flagged(program_to_code(main, verify=True)) == flagged(
        jcode(jmain, verify=True))
    assert program_to_code(main, diagnostics=[]) == program_to_code(main)
    ds = main.verify(level=None)
    assert ds and "// !! [" in program_to_code(main, diagnostics=ds)
    assert draw_block_graphviz(main.global_block(), diagnostics=[]) == \
        draw_block_graphviz(main.global_block())
