"""Decoder-only transformer LM: the Program builders and the paged decoder.

Counterpart of paddle_tpu/models/transformer.py.  The Program builders
(`transformer_lm` and its blocks) produce the same Program as the JAX
package's — same ops, attrs, variable names and shapes — so parameter
names extracted from it (`_lm_param_structure`) name the same trained
values in both packages.  All blocks are pre-LN (LN -> sublayer ->
residual add).

`build_lm_paged_decoder` is the serving decode step over a paged KV
cache, written in PyTorch, with attention through the hand-written CUDA
paged-attention kernel (kernels/paged_attention.py) on a CUDA device.
"""
from __future__ import annotations

import contextlib
import math
import types

import numpy as np
import torch

from .. import layers, nets
from ..core.executor import resolve_place
from ..core.flags import get_flag
from ..core.framework import Program, pipeline_stage, program_guard
from ..initializer import NormalInitializer

__all__ = [
    "multi_head_attention",
    "positionwise_ffn",
    "transformer_decoder",
    "transformer_lm",
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
    if dropout_rate:
        raise NotImplementedError("dropout layers are not ported yet")
    hidden = layers.fc(input=x, size=d_inner, num_flatten_dims=2,
                       act="relu")
    return layers.fc(input=hidden, size=d_model, num_flatten_dims=2)


def _pre_ln(x):
    return layers.layer_norm(x, begin_norm_axis=2)


def _embed(ids, vocab_size, d_model, max_len, dropout_rate, is_test):
    """Token embedding + learned positional embedding sized to max_len
    (the current static length slices into it)."""
    seq = int(ids.shape[1])
    if seq > max_len:
        raise ValueError(f"sequence length {seq} exceeds max_len {max_len}")
    if dropout_rate:
        raise NotImplementedError("dropout layers are not ported yet")
    emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr={"initializer": NormalInitializer(0.0, 0.02)})
    pos_table = layers.create_parameter(
        shape=[max_len, d_model], dtype=emb.dtype,
        default_initializer=NormalInitializer(0.0, 0.02))
    pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq])
    return layers.elementwise_add(emb, pos, axis=1)


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
    (n_layers/S consecutive blocks per stage).  `remat` (None reads the
    `remat` flag) needs the recompute layer, which is not ported: asking
    for it raises."""
    d_inner = d_inner or 4 * d_model
    if remat is None:
        remat = bool(get_flag("remat")) and not pipeline_stages
    if remat:
        raise NotImplementedError(
            "remat needs layers.recompute, which is not ported yet "
            "(ROADMAP A4); build with remat=False")
    if pipeline_stages and n_layers % pipeline_stages:
        raise ValueError(
            f"n_layers {n_layers} must be a multiple of "
            f"pipeline_stages {pipeline_stages}")
    x = _embed(tgt_ids, vocab_size, d_model, max_len, dropout_rate,
               is_test)
    for i in range(n_layers):
        stage = (pipeline_stage(i * pipeline_stages // n_layers)
                 if pipeline_stages else contextlib.nullcontext())
        with stage:
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
_M32 = 0xFFFFFFFF


def _mix32(x):
    """Bijective 32-bit integer hash on int64 tensors holding values in
    [0, 2^32); multipliers stay below 2^31 so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def _uniforms(seeds, positions, vocab):
    """[S, vocab] float32 uniforms in (0, 1), a counter-based function of
    (seed, position, token id) alone."""
    key = _mix32(_mix32(seeds & _M32) ^ (positions & _M32))
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    col = _mix32((ids * 0x2545F491 + 0x9E3779B9) & _M32)
    bits = _mix32(key[:, None] ^ col[None, :])
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
