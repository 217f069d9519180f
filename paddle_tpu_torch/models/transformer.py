"""Transformer family: the decoder-only LM, the encoder-decoder
translator, the generation builders and the LM's paged decoder.

Counterpart of paddle_tpu/models/transformer.py.  The Program builders
(`transformer_lm`, `transformer_translate` and their blocks) produce
the same Program as the JAX package's — same ops, attrs, variable
names and shapes — so parameter names extracted from it
(`_lm_param_structure`) name the same trained values in both packages.
All blocks are pre-LN (LN -> sublayer -> residual add).

The generation builders decode a closed batch: `build_lm_generator`
and `build_translate_generator` re-run the fixed-width Program once a
token (a replayed CUDA graph on a card, flash attention inside it),
`build_lm_kv_decoder` keeps dense per-layer K/V caches and computes one
token a step, `build_lm_beam_search` folds a fixed [B, K] beam into the
batch.  `build_lm_paged_decoder` is the serving decode step over a
paged KV cache, written in PyTorch, with attention through the
hand-written CUDA paged-attention kernel (kernels/paged_attention.py) on
a CUDA device.
"""
from __future__ import annotations

import contextlib
import math
import types

import numpy as np
import torch

from .. import layers, nets
from ..core.execution import _M32, mix32_
from ..core.executor import program_to_fn, resolve_place
from ..core.flags import get_flag
from ..core.framework import Program, pipeline_stage, program_guard
from ..initializer import NormalInitializer

__all__ = [
    "multi_head_attention",
    "positionwise_ffn",
    "transformer_encoder",
    "transformer_decoder",
    "transformer_lm",
    "transformer_translate",
    "build_lm_generator",
    "build_lm_kv_decoder",
    "build_translate_generator",
    "build_lm_beam_search",
    "build_lm_paged_decoder",
    "states_from_reference",
    "sample_tokens",
]


def _proj(x, size, name=None):
    """Linear projection over the feature axis of a [b, s, d] tensor."""
    return layers.fc(input=x, size=size, num_flatten_dims=2,
                     bias_attr=True, act=None, name=name)


def multi_head_attention(queries, keys, values, d_model, n_heads,
                         causal=False, dropout_rate=0.0, is_test=False):
    """Projected multi-head attention on [b, s, d] tensors; queries and
    keys/values may have different sequence lengths (cross attention)."""
    q = _proj(queries, d_model)
    k = _proj(keys, d_model)
    v = _proj(values, d_model)
    ctx = nets.scaled_dot_product_attention(
        q, k, v, num_heads=n_heads, dropout_rate=dropout_rate,
        causal=causal, is_test=is_test)
    return _proj(ctx, d_model)


def positionwise_ffn(x, d_model, d_inner, dropout_rate=0.0, is_test=False):
    hidden = layers.fc(input=x, size=d_inner, num_flatten_dims=2,
                       act="relu")
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate,
                                is_test=is_test)
    return layers.fc(input=hidden, size=d_model, num_flatten_dims=2)


def _pre_ln(x):
    return layers.layer_norm(x, begin_norm_axis=2)


def _embed(ids, vocab_size, d_model, max_len, dropout_rate, is_test):
    """Token embedding + learned positional embedding sized to max_len
    (the current static length slices into it)."""
    seq = int(ids.shape[1])
    if seq > max_len:
        raise ValueError(f"sequence length {seq} exceeds max_len {max_len}")
    emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr={"initializer": NormalInitializer(0.0, 0.02)})
    pos_table = layers.create_parameter(
        shape=[max_len, d_model], dtype=emb.dtype,
        default_initializer=NormalInitializer(0.0, 0.02))
    pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq])
    x = layers.elementwise_add(emb, pos, axis=1)
    if dropout_rate:
        x = layers.dropout(x, dropout_prob=dropout_rate, is_test=is_test)
    return x


def _encoder_block(x, d_model, n_heads, d_inner, dropout_rate, is_test):
    ln_x = _pre_ln(x)
    a = multi_head_attention(ln_x, ln_x, ln_x, d_model, n_heads,
                             causal=False, dropout_rate=dropout_rate,
                             is_test=is_test)
    x = layers.elementwise_add(x, a)
    f = positionwise_ffn(_pre_ln(x), d_model, d_inner, dropout_rate, is_test)
    return layers.elementwise_add(x, f)


def transformer_encoder(src_ids, vocab_size, d_model=256, n_heads=4,
                        n_layers=2, d_inner=None, max_len=2048,
                        dropout_rate=0.0, is_test=False, remat=None):
    """Bidirectional encoder over [b, s] token ids -> [b, s, d_model].

    `remat=True` wraps each block in layers.recompute: the block's
    activations are re-run in the backward instead of kept, a forward's
    time for the block's activation memory.  remat=None reads the
    `remat` flag (build time)."""
    d_inner = d_inner or 4 * d_model
    if remat is None:
        remat = bool(get_flag("remat"))
    x = _embed(src_ids, vocab_size, d_model, max_len, dropout_rate,
               is_test)
    for _ in range(n_layers):
        if remat:
            x = layers.recompute(
                lambda x=x: _encoder_block(x, d_model, n_heads, d_inner,
                                           dropout_rate, is_test))
        else:
            x = _encoder_block(x, d_model, n_heads, d_inner, dropout_rate,
                               is_test)
    return _pre_ln(x)


def _decoder_block(x, enc_out, d_model, n_heads, d_inner, dropout_rate,
                   is_test):
    ln_x = _pre_ln(x)
    a = multi_head_attention(ln_x, ln_x, ln_x, d_model, n_heads,
                             causal=True, dropout_rate=dropout_rate,
                             is_test=is_test)
    x = layers.elementwise_add(x, a)
    if enc_out is not None:
        c = multi_head_attention(_pre_ln(x), enc_out, enc_out, d_model,
                                 n_heads, causal=False,
                                 dropout_rate=dropout_rate, is_test=is_test)
        x = layers.elementwise_add(x, c)
    f = positionwise_ffn(_pre_ln(x), d_model, d_inner, dropout_rate, is_test)
    return layers.elementwise_add(x, f)


def transformer_decoder(tgt_ids, enc_out, vocab_size, d_model=256,
                        n_heads=4, n_layers=2, d_inner=None, max_len=2048,
                        dropout_rate=0.0, is_test=False, remat=None,
                        pipeline_stages=None):
    """Causal decoder ([b, t] ids, optional [b, s, d] memory) -> [b, t, d].

    `pipeline_stages=S` annotates the block stack with `pipeline_stage`
    (n_layers/S consecutive blocks per stage).  `remat` as in
    transformer_encoder; the flag never applies to a pipeline build, and
    remat=True with pipeline stages raises."""
    d_inner = d_inner or 4 * d_model
    if remat is None:
        # the `remat` flag never overrides a pipeline build (the GPipe
        # schedule already recomputes per microbatch)
        remat = bool(get_flag("remat")) and not pipeline_stages
    if pipeline_stages:
        if n_layers % pipeline_stages:
            raise ValueError(
                f"n_layers {n_layers} must be a multiple of "
                f"pipeline_stages {pipeline_stages}")
        if remat:
            raise NotImplementedError(
                "remat inside pipeline stages is redundant: the GPipe "
                "schedule already recomputes per-microbatch")
    x = _embed(tgt_ids, vocab_size, d_model, max_len, dropout_rate,
               is_test)
    for i in range(n_layers):
        stage = (pipeline_stage(i * pipeline_stages // n_layers)
                 if pipeline_stages else contextlib.nullcontext())
        with stage:
            if remat:
                x = layers.recompute(
                    lambda x=x: _decoder_block(x, enc_out, d_model,
                                               n_heads, d_inner,
                                               dropout_rate, is_test))
            else:
                x = _decoder_block(x, enc_out, d_model, n_heads, d_inner,
                                   dropout_rate, is_test)
    return _pre_ln(x)


def transformer_lm(ids, vocab_size, d_model=256, n_heads=4, n_layers=2,
                   d_inner=None, max_len=2048, dropout_rate=0.0,
                   is_test=False, return_logits=False,
                   pipeline_stages=None):
    """Decoder-only causal language model: [b, s] ids -> [b, s, vocab]
    next-token softmax probabilities (raw logits with
    `return_logits=True`)."""
    h = transformer_decoder(ids, None, vocab_size, d_model, n_heads,
                            n_layers, d_inner, max_len, dropout_rate,
                            is_test, pipeline_stages=pipeline_stages)
    logits = layers.fc(input=h, size=vocab_size, num_flatten_dims=2)
    if return_logits:
        return logits
    return layers.softmax(logits)


def transformer_translate(src_ids, tgt_ids, src_vocab, tgt_vocab,
                          d_model=256, n_heads=4, n_layers=2, d_inner=None,
                          max_len=2048, dropout_rate=0.0, is_test=False,
                          return_logits=False, remat=None):
    """Encoder-decoder translation model -> [b, t, tgt_vocab] softmax
    (raw logits with `return_logits=True`, for
    softmax_with_cross_entropy: the [b*t, vocab] probabilities are then
    never materialised)."""
    enc = transformer_encoder(src_ids, src_vocab, d_model, n_heads,
                              n_layers, d_inner, max_len, dropout_rate,
                              is_test, remat=remat)
    dec = transformer_decoder(tgt_ids, enc, tgt_vocab, d_model, n_heads,
                              n_layers, d_inner, max_len, dropout_rate,
                              is_test, remat=remat)
    logits = layers.fc(input=dec, size=tgt_vocab, num_flatten_dims=2)
    if return_logits:
        return logits
    return layers.softmax(logits)


def _lm_param_structure(vocab_size, max_len, d_model, n_heads, n_layers,
                        d_inner):
    """Build the LM Program once and extract its parameter names
    STRUCTURALLY (op walk, creation order) so the hand-written decoder
    computes over the same trained values as the Program.

    Returns (startup, shapes, tok_emb, pos_tab, lns, weights, biases)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids_in = layers.data(name="gen_ids", shape=[max_len],
                             dtype="int64")
        transformer_lm(ids_in, vocab_size, d_model=d_model,
                       n_heads=n_heads, n_layers=n_layers,
                       d_inner=d_inner, max_len=max_len, is_test=True)

    blk = main.global_block()
    params = {v.name for v in blk.all_parameters()}
    tok_emb = pos_tab = None
    lns, weights, biases = [], [], []
    for op in blk.ops:
        if op.type == "lookup_table":
            tok_emb = op.inputs["W"][0]
        elif op.type == "slice" and op.inputs["Input"][0] in params:
            pos_tab = op.inputs["Input"][0]
        elif op.type == "layer_norm":
            lns.append((op.inputs["Scale"][0], op.inputs["Bias"][0]))
        elif op.type == "mul":
            weights.append(op.inputs["Y"][0])
        elif op.type == "elementwise_add":
            y = op.inputs.get("Y", [None])[0]
            if y in params and len(biases) < len(weights):
                biases.append(y)
    if not (tok_emb and pos_tab and len(weights) == 6 * n_layers + 1
            and len(lns) == 2 * n_layers + 1
            and len(biases) == len(weights)):
        raise RuntimeError("unexpected LM program structure")
    shapes = {v.name: tuple(int(d) for d in v.shape)
              for v in blk.all_parameters()}
    return startup, shapes, tok_emb, pos_tab, lns, weights, biases


def states_from_reference(states_np, decoder, device, *, who="target"):
    """Parameter dict (name -> array or tensor, e.g. the JAX package's
    scope values or a saved model's npz) -> {name: float32 tensor on
    `device`} for
    `decoder`.  Names and shapes are checked against the decoder's; extra
    names are ignored.  `device` is a torch.device or a place."""
    missing = [n for n in decoder.state_names if n not in states_np]
    if missing:
        raise ValueError(
            f"{who} states missing {len(missing)} decoder "
            f"parameter(s), e.g. {missing[:3]} — rebuild the "
            "decoder under the same unique-name state the "
            "parameters were trained in")
    # matching NAMES are not enough: a spec that rebuilds the decoder at
    # the wrong max_len/d_model would index the position table out of
    # bounds on the device
    bad = [(n, tuple(np.shape(states_np[n])), want)
           for n, want in decoder.state_shapes.items()
           if tuple(np.shape(states_np[n])) != want]
    if bad:
        n, got, want = bad[0]
        raise ValueError(
            f"{len(bad)} {who} parameter shape(s) do not match "
            f"the decoder architecture, e.g. {n}: states {got} "
            f"vs decoder {want} — the model spec (vocab_size/"
            "d_model/n_heads/n_layers/block_size*"
            "max_blocks_per_seq) disagrees with the saved "
            "parameters")
    dev = resolve_place(device)
    out = {}
    for n in decoder.state_names:
        v = states_np[n]
        if isinstance(v, torch.Tensor):
            out[n] = v.detach().to(device=dev, dtype=torch.float32)
        else:
            out[n] = torch.tensor(np.asarray(v, np.float32), device=dev)
    return out


# -- stateless per-(seed, position) sampling --------------------------------

def _uniforms(seeds, positions, vocab):
    """[S, vocab] float32 uniforms in (0, 1), a counter-based function of
    (seed, position, token id) alone."""
    key = mix32_(mix32_(seeds & _M32) ^ (positions & _M32))
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    col = mix32_((ids * 0x2545F491 + 0x9E3779B9) & _M32)
    bits = mix32_(key[:, None] ^ col[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) / 16777216.0


def sample_tokens(logits, seeds, positions, temps):
    """Greedy argmax where temps == 0, else a Gumbel-max draw from
    softmax(logits / temp) whose noise depends only on (seed, position)
    — never on the slot or the tick, so a retried or re-scheduled
    sequence resamples identically.  The JAX package draws from
    fold_in(key(seed), position) with threefry: the same contract with
    other random bits.  logits [S, V]; seeds, positions int64 [S];
    temps float32 [S] -> int32 [S]."""
    greedy = logits.argmax(dim=-1)
    hot = temps > 0
    if not bool(hot.any()):
        return greedy.to(torch.int32)
    u = _uniforms(seeds, positions, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    safe_t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
    sampled = (logits / safe_t + gumbel).argmax(dim=-1)
    return torch.where(hot, sampled, greedy).to(torch.int32)


_NP_OF = {torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32, torch.bool: np.bool_}


def _as(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x).astype(_NP_OF[dtype]), device=device)


def _lm_forward_fn(vocab_size, max_len, d_model, n_heads, n_layers,
                   d_inner, place):
    """The LM Program at width `max_len` as a `program_to_fn` function
    -> (startup, fn, the probabilities' name).  On a card its fetches
    are the graph's own outputs: the decode loops read the row they
    need before the next call."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids_in = layers.data(name="gen_ids", shape=[max_len],
                             dtype="int64")
        probs = transformer_lm(ids_in, vocab_size, d_model=d_model,
                               n_heads=n_heads, n_layers=n_layers,
                               d_inner=d_inner, max_len=max_len,
                               is_test=True)
    fn = program_to_fn(main, ["gen_ids"], [probs.name], place=place)
    return startup, fn, probs.name


def _device_states(states, device):
    """{name: float32 tensor on `device`}: tensors already there pass
    as they are (a replay then copies nothing)."""
    return {n: v if isinstance(v, torch.Tensor) and v.device == device
            and v.dtype == torch.float32 else _as(v, torch.float32, device)
            for n, v in states.items()}


def _prompt_ids(prompt_ids, width, device, fill=0):
    """[B, P] prompt -> ([B, width] int64 ids on `device` holding it in
    front, P)."""
    prompt = _as(prompt_ids, torch.int64, device)
    b, p = prompt.shape
    ids = torch.full((b, width), fill, dtype=torch.int64, device=device)
    ids[:, :p] = prompt
    return ids, p


def _categorical(logits, generator):
    """A draw from softmax(logits) per row by the Gumbel-max trick, its
    noise from `generator` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_min_(1e-20)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1)


def _generator(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def build_lm_generator(vocab_size, max_len, d_model=256, n_heads=4,
                       n_layers=2, d_inner=None, place=None):
    """Autoregressive generation for the decoder-only LM: the LM Program
    at the fixed width `max_len`, as a `program_to_fn` function, re-run
    once per token (the causal mask makes the positions past the cursor
    inert, so the fixed-width forward is exact).  On a CUDA place the
    forward is one CUDA graph, captured at the second token and replayed
    for every token after; the ids stay on the card, and no token reads
    anything back to the host.

    Returns (startup_program, generate) where
      generate(states, prompt_ids [B, P], num_steps, temperature=0.0,
               seed=0) -> ids [B, max_len] int64 on the device
    with greedy argmax at temperature 0 and softmax sampling otherwise
    (Gumbel-max, its noise from a torch.Generator seeded with `seed`;
    the JAX package draws jax.random.categorical: the same
    distribution, other numbers).  `states` maps the Program's
    parameter names (`generate.state_names`) to arrays or tensors."""
    startup, fn, probs = _lm_forward_fn(vocab_size, max_len, d_model,
                                        n_heads, n_layers, d_inner, place)
    device = fn.device

    def generate(states, prompt_ids, num_steps, temperature=0.0, seed=0):
        g = _device_states(states, device)
        ids, p = _prompt_ids(prompt_ids, max_len, device)
        if p + num_steps > max_len:
            raise ValueError(f"prompt {p} + {num_steps} steps exceeds "
                             f"max_len {max_len}")
        gen = _generator(device, seed) if temperature > 0 else None
        with torch.no_grad():
            for i in range(p, p + int(num_steps)):
                step_p = fn({"gen_ids": ids}, g)[0][probs][:, i - 1]
                if gen is not None:
                    nxt = _categorical(torch.log(step_p + 1e-9)
                                       / float(temperature), gen)
                else:
                    nxt = step_p.argmax(dim=-1)
                ids[:, i] = nxt
        return ids

    generate.state_names = list(fn.state_in_names)
    generate.forward = fn
    return startup, generate


def build_lm_kv_decoder(vocab_size, max_len, d_model=256, n_heads=4,
                        n_layers=2, d_inner=None, place=None):
    """Incremental (KV-cache) generation for the decoder-only LM: per
    layer dense K/V caches [B, max_len, d_model] and ONE token a step,
    written in PyTorch over the LM Program's parameters (their names
    extracted structurally, `_lm_param_structure`), with the JAX
    package's math: pre-LN, a -inf mask past the cursor, relu in the
    FFN.  Prompt tokens go through the same step one at a time.

    The step reads its cursor from a device scalar and advances it
    itself, so on a CUDA place a greedy decode is one CUDA graph of one
    step, captured once per batch size and replayed once per position,
    with nothing read back to the host.  Sampling (temperature > 0)
    runs the same step eagerly, its Gumbel noise drawn from a
    torch.Generator seeded with `seed`.

    Returns (startup_program, generate) with `build_lm_generator`'s
    signature."""
    d_inner = d_inner or 4 * d_model
    d_head = d_model // n_heads
    scale = 1.0 / math.sqrt(d_head)
    startup, shapes, tok_emb, pos_tab, lns, weights, biases = (
        _lm_param_structure(vocab_size, max_len, d_model, n_heads,
                            n_layers, d_inner))
    device = resolve_place(place)
    graphs = {}     # batch size -> the captured step and its buffers

    def ln(g, x, i):
        s_, b_ = g[lns[i][0]], g[lns[i][1]]
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * s_ + b_

    def step(g, buf, noise=None):
        """One position: reads ids at the cursor `pos`, writes each
        layer's K/V there, writes the next id (the prompt's while the
        cursor is inside it) at pos + 1, and advances pos, in place."""
        ids, caches, pos, plen = (buf["ids"], buf["caches"], buf["pos"],
                                  buf["plen"])
        b = ids.shape[0]

        def lin(h, i):
            return h @ g[weights[i]] + g[biases[i]]

        at = pos.view(1)
        tok = ids.index_select(1, at)[:, 0]
        x = g[tok_emb][tok] + g[pos_tab].index_select(0, at)
        visible = torch.arange(max_len, device=ids.device) <= pos
        for l in range(n_layers):
            h = ln(g, x, 2 * l)
            q = lin(h, 6 * l + 0)
            ck, cv = caches[l]
            ck.index_copy_(1, at, lin(h, 6 * l + 1)[:, None, :])
            cv.index_copy_(1, at, lin(h, 6 * l + 2)[:, None, :])
            qh = q.reshape(b, n_heads, d_head)
            kh = ck.reshape(b, max_len, n_heads, d_head)
            vh = cv.reshape(b, max_len, n_heads, d_head)
            sc = torch.einsum("bhd,bshd->bhs", qh, kh) * scale
            sc = sc.masked_fill(~visible, float("-inf"))
            w_att = torch.softmax(sc, dim=-1)
            ctxh = torch.einsum("bhs,bshd->bhd", w_att, vh)
            x = x + lin(ctxh.reshape(b, d_model), 6 * l + 3)
            h2 = ln(g, x, 2 * l + 1)
            x = x + lin(torch.relu(lin(h2, 6 * l + 4)), 6 * l + 5)
        logits = lin(ln(g, x, 2 * n_layers), 6 * n_layers)     # [B, V]
        nxt = (logits.argmax(dim=-1) if noise is None
               else _categorical(logits / noise[1], noise[0]))
        nat = at + 1
        cur = ids.index_select(1, nat)[:, 0]
        ids.index_copy_(1, nat, torch.where(nat < plen, cur, nxt)[:, None])
        pos.add_(1)

    def buffers(b):
        return {"ids": torch.zeros((b, max_len), dtype=torch.int64,
                                   device=device),
                "caches": [(torch.zeros((b, max_len, d_model),
                                        device=device),
                            torch.zeros((b, max_len, d_model),
                                        device=device))
                           for _ in range(n_layers)],
                "pos": torch.zeros((), dtype=torch.int64, device=device),
                "plen": torch.zeros((), dtype=torch.int64, device=device)}

    def reset(buf, ids0, p):
        buf["ids"].copy_(ids0)
        for ck, cv in buf["caches"]:
            ck.zero_()
            cv.zero_()
        buf["pos"].zero_()
        buf["plen"].fill_(p)

    def graphed(g, ids0, p):
        """The batch's captured step (made at its first greedy decode:
        a warm-up step, then the capture) with the states copied into
        its private buffers, once a decode: nothing changes them
        between its positions, and a tensor's identity and version
        cannot tell whether a graph replay rewrote it since the last."""
        b = ids0.shape[0]
        ent = graphs.get(b)
        if ent is None:
            gb = {n: v.clone() for n, v in g.items()}
            buf = buffers(b)
            reset(buf, ids0, p)
            step(gb, buf)                 # warm-up: kernels, handles
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step(gb, buf)
            ent = graphs[b] = {"graph": graph, "g": gb, "buf": buf}
        else:
            for n, v in g.items():
                ent["g"][n].copy_(v)
        reset(ent["buf"], ids0, p)
        return ent

    def generate(states, prompt_ids, num_steps, temperature=0.0, seed=0):
        g = _device_states(states, device)
        ids0, p = _prompt_ids(prompt_ids, max_len, device)
        if p + num_steps > max_len:
            raise ValueError(f"prompt {p} + {num_steps} steps exceeds "
                             f"max_len {max_len}")
        n = p + int(num_steps) - 1
        with torch.no_grad():
            if temperature > 0 or device.type != "cuda":
                buf = buffers(ids0.shape[0])
                reset(buf, ids0, p)
                noise = ((_generator(device, seed), float(temperature))
                         if temperature > 0 else None)
                for _ in range(n):
                    step(g, buf, noise)
                return buf["ids"]
            ent = graphed(g, ids0, p)
            for _ in range(n):
                ent["graph"].replay()
            return ent["buf"]["ids"].clone()

    generate.state_names = sorted(shapes)
    generate.state_shapes = shapes
    generate.graphs = graphs
    return startup, generate


def build_translate_generator(src_vocab, tgt_vocab, max_src_len,
                              max_tgt_len, d_model=256, n_heads=4,
                              n_layers=2, d_inner=None, bos_id=0,
                              eos_id=1, place=None):
    """Greedy translation decode for the encoder-decoder transformer
    (`build_lm_generator`'s design: the fixed-width translator Program
    re-run once per target position, one CUDA graph replayed per step
    on a card, the ids on the device).

    Returns (startup_program, translate) where
      translate(states, src_ids [B, max_src_len], num_steps) ->
          tgt ids [B, max_tgt_len] int64 starting with bos_id; a row
          that emitted eos_id keeps emitting it."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data(name="gen_src", shape=[max_src_len],
                          dtype="int64")
        tgt = layers.data(name="gen_tgt", shape=[max_tgt_len],
                          dtype="int64")
        probs = transformer_translate(
            src, tgt, src_vocab, tgt_vocab, d_model=d_model,
            n_heads=n_heads, n_layers=n_layers, d_inner=d_inner,
            max_len=max(max_src_len, max_tgt_len), is_test=True)
    fn = program_to_fn(main, ["gen_src", "gen_tgt"], [probs.name],
                       place=place)
    device = fn.device

    def translate(states, src_ids, num_steps):
        if num_steps >= max_tgt_len:
            raise ValueError(f"num_steps {num_steps} must be below "
                             f"max_tgt_len {max_tgt_len}")
        g = _device_states(states, device)
        src_t = _as(src_ids, torch.int64, device)
        tgt_t = torch.full((src_t.shape[0], max_tgt_len), eos_id,
                           dtype=torch.int64, device=device)
        tgt_t[:, 0] = bos_id
        with torch.no_grad():
            for i in range(1, 1 + int(num_steps)):
                step_p = fn({"gen_src": src_t, "gen_tgt": tgt_t},
                            g)[0][probs.name][:, i - 1]
                nxt = step_p.argmax(dim=-1)
                # once a row emitted eos, it keeps emitting eos
                tgt_t[:, i] = torch.where(tgt_t[:, i - 1] == eos_id,
                                          eos_id, nxt)
        return tgt_t

    translate.state_names = list(fn.state_in_names)
    translate.forward = fn
    return startup, translate


def _top_k_lowest_first(x, k):
    """The k largest of each row, ties to the lower index first (as
    lax.top_k breaks them; torch.topk promises no order among ties)
    -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def build_lm_beam_search(vocab_size, max_len, beam_size=4, d_model=256,
                         n_heads=4, n_layers=2, d_inner=None, place=None):
    """Static-shape beam search for the decoder-only LM: the beam is a
    fixed [B, K] folded into the batch; each step scores all K beams in
    one fixed-width forward (B*K rows, `build_lm_generator`'s replayed
    graph on a card), takes the top K of the K*V continuation scores
    (ties to the lower index, as lax.top_k) and regathers the winning
    prefixes.  At the first expansion only beam 0 is a real hypothesis.

    Returns (startup_program, search) where
      search(states, prompt_ids [B, P], num_steps) ->
          (ids [B, K, max_len] int64, scores [B, K]) best first; scores
          are sums of log p (no EOS handling: all beams share one
          length)."""
    startup, fn, probs = _lm_forward_fn(vocab_size, max_len, d_model,
                                        n_heads, n_layers, d_inner, place)
    device = fn.device
    K = int(beam_size)

    def search(states, prompt_ids, num_steps):
        g = _device_states(states, device)
        ids0, p = _prompt_ids(prompt_ids, max_len, device)
        if p + num_steps > max_len:
            raise ValueError(f"prompt {p} + {num_steps} steps exceeds "
                             f"max_len {max_len}")
        b = ids0.shape[0]
        ids = ids0[:, None, :].expand(b, K, max_len).contiguous()
        scores = torch.zeros((b, K), device=device)
        with torch.no_grad():
            for i in range(p, p + int(num_steps)):
                step_p = fn({"gen_ids": ids.reshape(b * K, max_len)},
                            g)[0][probs][:, i - 1]
                cand = scores[:, :, None] + torch.log(
                    step_p.reshape(b, K, vocab_size) + 1e-9)
                if i == p:
                    cand[:, 1:] = float("-inf")
                scores, top = _top_k_lowest_first(
                    cand.reshape(b, K * vocab_size), K)
                src_beam = top // vocab_size
                ids = ids.gather(1, src_beam[:, :, None].expand(
                    b, K, max_len))
                ids[:, :, i] = top % vocab_size
        return ids, scores

    search.state_names = list(fn.state_in_names)
    search.forward = fn
    return startup, search


def build_lm_paged_decoder(vocab_size, block_size, max_blocks_per_seq,
                           d_model=256, n_heads=4, n_layers=2,
                           d_inner=None, kv_dtype=None, place=None):
    """Paged-attention decode step for the decoder-only LM.

    K/V live in fixed-size BLOCKS inside one shared pool ([n_layers,
    num_blocks, block_size, d_model]) and each sequence owns an ordered
    block table mapping its logical positions onto pool blocks.
    Attention reads through the table, so per-slot math is independent
    of which physical blocks a sequence owns and of what other slots
    compute — continuously-batched decode is bit-identical to running
    the same prompt solo.

    `place` (default CUDAPlace(0); raises with no CUDA device unless
    CPUPlace() is given) is where the step runs.  On a CUDA device
    attention goes through the hand-written paged-attention kernel when
    the `serving_kernels` flag arms it ("auto", the default, does);
    otherwise through its plain PyTorch version.  Which one runs is
    `decoder.kernels["paged_attention_decode"]` ("cuda" or
    "plain:<reason>").

    Returns (startup_program, decoder):
      decoder.step(states, pool_k, pool_v, tables, positions, tokens,
                   seeds, temps, active)
          -> (next_tokens [S] int32, pool_k, pool_v)
        tables    [S, max_blocks_per_seq] int32 pool-block ids (unused
                  tail entries must point at a valid block, e.g. the
                  pool's reserved null block 0 — they are masked out)
        positions [S] int32 logical cursor: `tokens[s]` is the token AT
                  this position; the step writes its K/V there and
                  returns the model's prediction for position+1
        seeds     [S] uint32 per-sequence sampling seed (sampling depends
                  only on (seed, position): see `sample_tokens`)
        temps     [S] float32, 0 = greedy argmax
        active    [S] bool; inactive slots write into the null block
                  and their outputs are meaningless
      decoder.step_window(states, pool_k, pool_v, tables, positions,
                          tokens [S, W], seeds, temps, n_valid [S])
          -> (preds [S, W] int32, pool_k, pool_v)
        the teacher-forced MULTI-position step: slot s processes
        positions positions[s] .. positions[s]+n_valid[s]-1 (causal
        within the window), writing each position's K/V and returning
        each position's prediction — chunked prefill and speculative
        verification.  Rows past n_valid write into the null block.
      decoder.init_pool(num_blocks, place=None) -> (pool_k, pool_v) zero
        blocks on `place` (default: the decoder's place)
      decoder.state_names / state_shapes — parameter names and shapes,
        the same as the JAX package's for the same architecture.

    Inputs may be numpy arrays or tensors; states are
    `states_from_reference` tensors on the decoder's device.  Steps run
    under torch.inference_mode() and update the pools IN PLACE: they
    return the same pool objects they were given (the JAX decoder
    returns new, donated buffers instead).

    `kv_dtype` selects the POOL's storage precision (compute stays
    float32): "fp32" (default); "bf16" (blocks stored bfloat16); "int8"
    (blocks stored int8 with ONE float32 scale per (layer, block); a
    write re-quantizes the whole target block under the new running max
    — blocks fill strictly in position order, so the valid region is
    exactly the offsets below the cursor).  int8 pools are (payload,
    scales) tuples.  None reads the `serving_kv_dtype` flag.
    """
    from ..kernels.paged_attention import paged_attention_reference
    from ..kernels.registry import Selection

    d_inner = d_inner or 4 * d_model
    nb, bs = int(max_blocks_per_seq), int(block_size)
    max_len = nb * bs
    if kv_dtype is None:
        kv_dtype = get_flag("serving_kv_dtype") or "fp32"
    kv_dtype = {"float32": "fp32", "bfloat16": "bf16"}.get(
        str(kv_dtype).lower(), str(kv_dtype).lower())
    if kv_dtype not in ("fp32", "bf16", "int8"):
        raise ValueError(
            f"kv_dtype {kv_dtype!r} not in ('fp32', 'bf16', 'int8')")
    device = resolve_place(place)

    kernel_selection = Selection()
    attend = kernel_selection.pick(
        "paged_attention_decode", platform=device.type, d_model=d_model,
        n_heads=n_heads, block_size=bs, max_blocks_per_seq=nb,
        kv_dtype=kv_dtype)
    if attend is None:
        def attend(q, pool_k, pool_v, tables, positions, layer):
            return paged_attention_reference(q, pool_k, pool_v, tables,
                                             positions, layer,
                                             n_heads=n_heads)

    startup, shapes, tok_emb, pos_tab, lns, weights, biases = (
        _lm_param_structure(vocab_size, max_len, d_model, n_heads,
                            n_layers, d_inner))

    # -- pool storage: quantize-on-write / dequantize-on-read --------------
    def _write(pool, l, wb, wi, row):
        """Write `row` [S, D] at (layer l, block wb[s], offset wi[s])."""
        if kv_dtype == "fp32":
            pool[l, wb, wi] = row
            return
        if kv_dtype == "bf16":
            pool[l, wb, wi] = row.to(torch.bfloat16)
            return
        q, sc = pool
        # int8, one scale per (layer, block): re-quantize the whole block
        # under the running max.  Offsets < wi are the valid entries;
        # everything above is stale (a reused block holds a dead
        # sequence's data) and must NOT widen the scale.
        deq = q[l, wb].float() * sc[l, wb][:, None, None]     # [S, BS, D]
        offs = torch.arange(bs, device=deq.device)
        deq = torch.where((offs[None, :] < wi[:, None])[..., None], deq,
                          torch.zeros((), device=deq.device))
        deq = torch.where((offs[None, :] == wi[:, None])[..., None],
                          row[:, None, :], deq)
        new_scale = torch.clamp_min(deq.abs().amax(dim=(1, 2)), 1e-8) / 127.0
        q[l, wb] = torch.clamp(torch.round(deq / new_scale[:, None, None]),
                               -127, 127).to(torch.int8)
        sc[l, wb] = new_scale

    def _ln(g, x, i):
        s_, b_ = g[lns[i][0]], g[lns[i][1]]
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * s_ + b_

    def _logits(g, x, pool_k, pool_v, tables, positions, wb, wi):
        """x [S, W, D] embedded window rows; wb/wi [S, W] write targets.
        Writes every row's K/V (in window order: int8 re-quantization
        needs offsets written low to high), then attends -> [S, W, V]."""

        def lin(h, i):
            return h @ g[weights[i]] + g[biases[i]]

        for l in range(n_layers):
            h = _ln(g, x, 2 * l)
            q = lin(h, 6 * l + 0)
            kk = lin(h, 6 * l + 1)
            vv = lin(h, 6 * l + 2)
            for j in range(x.shape[1]):
                _write(pool_k, l, wb[:, j], wi[:, j], kk[:, j])
                _write(pool_v, l, wb[:, j], wi[:, j], vv[:, j])
            ctx_av = attend(q, pool_k, pool_v, tables, positions, l)
            x = x + lin(ctx_av, 6 * l + 3)
            h2 = _ln(g, x, 2 * l + 1)
            x = x + lin(torch.relu(lin(h2, 6 * l + 4)), 6 * l + 5)
        return lin(_ln(g, x, 2 * n_layers), 6 * n_layers)

    @torch.inference_mode()
    def step(g, pool_k, pool_v, tables, positions, tokens, seeds, temps,
             active):
        tables = _as(tables, torch.int32, device)
        positions = _as(positions, torch.int32, device)
        tokens = _as(tokens, torch.int64, device)
        active = _as(active, torch.bool, device)
        pos = positions.long()
        lane = torch.arange(tokens.shape[0], device=device)
        x = g[tok_emb][tokens] + g[pos_tab][pos]                 # [S, D]
        # this tick's K/V land at the cursor's (block, offset); inactive
        # slots are routed to block 0 offset 0 — the pool's reserved
        # null/scratch block, never owned by a sequence
        zero = torch.zeros((), dtype=torch.int64, device=device)
        wb = torch.where(active, tables[lane, pos // bs].long(), zero)
        wi = torch.where(active, pos % bs, zero)
        logits = _logits(g, x[:, None], pool_k, pool_v, tables, positions,
                         wb[:, None], wi[:, None])[:, 0]
        nxt = sample_tokens(logits, _as(seeds, torch.int64, device), pos,
                            _as(temps, torch.float32, device))
        return nxt, pool_k, pool_v

    @torch.inference_mode()
    def step_window(g, pool_k, pool_v, tables, positions, tokens, seeds,
                    temps, n_valid):
        tables = _as(tables, torch.int32, device)
        positions = _as(positions, torch.int32, device)
        tokens = _as(tokens, torch.int64, device)
        n_valid = _as(n_valid, torch.int64, device)
        s_n, w_n = tokens.shape
        offs = torch.arange(w_n, device=device)
        pos_w = positions.long()[:, None] + offs[None, :]       # [S, W]
        valid = offs[None, :] < n_valid[:, None]
        pos_c = pos_w.clamp(0, max_len - 1)
        x = g[tok_emb][tokens] + g[pos_tab][pos_c]               # [S, W, D]
        lane = torch.arange(s_n, device=device)[:, None]
        zero = torch.zeros((), dtype=torch.int64, device=device)
        wb = torch.where(valid,
                         tables[lane, (pos_w // bs).clamp(0, nb - 1)].long(),
                         zero)
        wi = torch.where(valid, pos_w % bs, zero)
        logits = _logits(g, x, pool_k, pool_v, tables, positions, wb, wi)
        seeds_w = _as(seeds, torch.int64, device)[:, None].expand(s_n, w_n)
        temps_w = _as(temps, torch.float32, device)[:, None].expand(s_n, w_n)
        preds = sample_tokens(logits.reshape(s_n * w_n, -1),
                              seeds_w.reshape(-1), pos_c.reshape(-1),
                              temps_w.reshape(-1)).reshape(s_n, w_n)
        return preds, pool_k, pool_v

    if kv_dtype == "fp32":
        elem_bytes = 4.0
    elif kv_dtype == "bf16":
        elem_bytes = 2.0
    else:
        # int8 payload + one f32 scale per (layer, block)
        elem_bytes = 1.0 + 4.0 / (bs * d_model)
    bytes_per_block = int(2 * n_layers * bs * d_model * elem_bytes)

    def init_pool(num_blocks, place=None):
        dev = device if place is None else resolve_place(place)
        shape = (n_layers, int(num_blocks), bs, d_model)

        def z():
            if kv_dtype == "int8":
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.full((n_layers, int(num_blocks)), 1e-8,
                                   dtype=torch.float32, device=dev))
            dt = torch.bfloat16 if kv_dtype == "bf16" else torch.float32
            return torch.zeros(shape, dtype=dt, device=dev)

        return z(), z()

    decoder = types.SimpleNamespace(
        step=step, step_window=step_window, init_pool=init_pool,
        state_names=sorted(shapes), state_shapes=shapes, block_size=bs,
        max_blocks_per_seq=nb, max_len=max_len, n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, vocab_size=vocab_size,
        kv_dtype=kv_dtype, bytes_per_block=bytes_per_block, device=device,
        kernel_selection=kernel_selection,
        kernels=dict(kernel_selection.chosen))
    return startup, decoder
