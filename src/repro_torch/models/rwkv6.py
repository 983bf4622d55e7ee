"""RWKV-6 "Finch" (arXiv:2404.05892) in PyTorch: the attention-free LM.

Counterpart of ``repro/models/rwkv6.py``. Time-mixing: token shift with
data-dependent (LoRA-produced) interpolation, a data-dependent
per-channel decay w_t, and the WKV recurrence

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

per head of 64 (``kernels.ops.wkv6_op``: the Hopper kernel on the card, the
JAX model's plain forms on the CPU; the training forward takes the plain
forms on both). Channel-mixing: squared-ReLU MLP with token shift.
Parameters keep the JAX pytree (a stacked leading layer axis;
``decay_base`` and ``bonus_u`` stay f32 in any model dtype).

State per layer (decode is O(1) in context length):
  * ts_tm, ts_cm: (L, B, d) the last token's normed hidden for the shifts
  * wkv:          (L, B, H, 64, 64) f32 recurrent state

Entry points:
  init_lm(gen, cfg)                            -> params
  init_state(cfg, batch, device)               -> state
  prefill(params, state, tokens, lengths, cfg) -> (last_logits, state)
  decode(params, state, tokens, lengths, cfg)  -> (logits, state)
  forward_train(params, tokens, cfg)           -> logits (B, S, V)
  lm_loss(params, batch, cfg)                  -> scalar

Unlike the JAX functions, prefill and decode update ``state`` IN PLACE and
return the same dict.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
# ModelConfig only through L: kernels.ref imports this module, possibly
# while models.layers is still half-imported
from repro_torch.models import layers as L
from repro_torch.models import tp

LORA_DECAY = 64
LORA_MIX = 32
N_MIX = 5  # w, k, v, r, g
HEAD_SIZE = 64


def head_dims(cfg: L.ModelConfig) -> tuple[int, int]:
    return cfg.d_model // HEAD_SIZE, HEAD_SIZE


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dinit(gen, shape, dtype, scale=None, *, stack: int):
    """N(0, scale^2) drawn in f32 (scale defaults to 1/sqrt(shape[0])),
    stored in ``dtype``, ``stack`` layers along a new leading axis."""
    s = scale if scale is not None else 1.0 / math.sqrt(max(1, shape[0]))
    if gen.device.type == "meta":                  # layers.MetaGenerator
        return torch.empty((stack,) + tuple(shape), dtype=dtype,
                           device="meta")
    w = torch.randn((stack,) + tuple(shape), generator=gen,
                    dtype=torch.float32, device=gen.device)
    return (w * s).to(dtype)


def init_lm(gen: torch.Generator, cfg: L.ModelConfig):
    """Random weights from ``gen`` (on the device they go to), with the JAX
    initialisers' distributions."""
    n, d, dt, dev = cfg.num_layers, cfg.d_model, cfg.dtype, gen.device
    nh, hd = head_dims(cfg)

    def full(shape, value, dtype=dt):
        return torch.full((n,) + shape, value, dtype=dtype, device=dev)

    blocks = {
        "norm_tm": L.init_norm(cfg, dev, stack=n),
        "norm_cm": L.init_norm(cfg, dev, stack=n),
        "tm": {
            "mix_base": full((N_MIX, d), 0.0),
            "mix_x": full((d,), 0.0),
            "mix_w1": _dinit(gen, (d, N_MIX * LORA_MIX), dt, stack=n),
            "mix_w2": _dinit(gen, (N_MIX, LORA_MIX, d), dt, 0.01, stack=n),
            "wr": _dinit(gen, (d, d), dt, stack=n),
            "wk": _dinit(gen, (d, d), dt, stack=n),
            "wv": _dinit(gen, (d, d), dt, stack=n),
            "wg": _dinit(gen, (d, d), dt, stack=n),
            "wo": _dinit(gen, (d, d), dt, stack=n),
            "decay_base": full((d,), -6.0, torch.float32),
            "decay_w1": _dinit(gen, (d, LORA_DECAY), dt, stack=n),
            "decay_w2": _dinit(gen, (LORA_DECAY, d), dt, 0.01, stack=n),
            "bonus_u": _dinit(gen, (nh, hd), torch.float32, 0.5, stack=n),
            "ln_out_scale": full((d,), 1.0),
            "ln_out_bias": full((d,), 0.0),
        },
        "cm": {
            "mix_k": full((d,), 0.0),
            "mix_r": full((d,), 0.0),
            "wk": _dinit(gen, (d, cfg.d_ff), dt, stack=n),
            "wv": _dinit(gen, (cfg.d_ff, d), dt, stack=n),
            "wr": _dinit(gen, (d, d), dt, stack=n),
        },
    }
    return {"embed": L.init_embedding(gen, cfg), "blocks": blocks,
            "final_norm": L.init_norm(cfg, dev)}


def init_state(cfg: L.ModelConfig, batch: int, device):
    nh, hd = head_dims(cfg)
    lead = (cfg.num_layers, batch)
    return {
        "ts_tm": torch.zeros(lead + (cfg.d_model,), dtype=cfg.dtype,
                             device=device),
        "ts_cm": torch.zeros(lead + (cfg.d_model,), dtype=cfg.dtype,
                             device=device),
        "wkv": torch.zeros(lead + (nh, hd, hd), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# WKV6: out_t = r_t^T (S + diag(u) k_t v_t^T),  S <- diag(w_t) S + k_t v_t^T
# r, k, v, w: (B, T, H, D); u: (H, D) f32; s0: (B, H, D, D) f32 [key, value]
# (the plain forms, differentiable; ``kernels.ref`` picks among them on the
# CPU, the training forward calls them directly)
# ---------------------------------------------------------------------------


def wkv_scan(r, k, v, w, u, s0):
    """Sequential WKV (the oracle). Returns (out (B, T, H, D), sT) in f32."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """Chunked-parallel WKV: intra-chunk masked products, the state carried
    across chunks; exponents relative to the chunk's midpoint cumulative
    decay (f32-safe under the model's decay clip). Matches wkv_scan."""
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"wkv_chunked: T={t} is not a multiple of {chunk}")
    n = t // chunk

    def to_chunks(a):                                   # (n, B, H, C, D)
        return a.float().reshape(b, n, chunk, h, d).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    logw = torch.log(wc.clamp_min(1e-38))
    cum = logw.cumsum(dim=-2)                           # inclusive
    total = cum[..., -1:, :]
    mid = cum[..., chunk // 2:chunk // 2 + 1, :]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    uf = u.float()[None, :, None, :]
    s = s0.float()
    outs = []
    for i in range(n):
        rt, kt, vt = rc[i], kc[i], vc[i]
        cum_prev = cum[i] - logw[i]
        out_state = torch.einsum("bhcd,bhde->bhce",
                                 rt * torch.exp(cum_prev), s)
        r_dec = rt * torch.exp(cum_prev - mid[i])
        kj = kt * torch.exp(mid[i] - cum[i])
        att = torch.einsum("bhid,bhjd->bhij", r_dec, kj)
        att = torch.where(mask, att, torch.zeros((), device=r.device))
        diag = torch.einsum("bhid,bhid->bhi", rt * uf, kt)
        out_intra = torch.einsum("bhij,bhjd->bhid", att, vt) \
            + diag[..., None] * vt
        k_dec = kt * torch.exp(total[i] - cum[i])
        s = torch.exp(total[i].squeeze(-2))[..., None] * s + torch.einsum(
            "bhcd,bhce->bhde", k_dec, vt)
        outs.append(out_state + out_intra)
    out = torch.stack(outs)                             # (n, B, H, C, D)
    return out.permute(1, 0, 3, 2, 4).reshape(b, t, h, d), s


def wkv_sequence(r, k, v, w, u, s0):
    """The form the JAX ``_time_mix`` picks in its "chunked" mode:
    ``wkv_chunked`` when T is a positive multiple of 64, ``wkv_scan``
    otherwise."""
    t = r.shape[1]
    if t % 64 == 0 and t >= 64:
        return wkv_chunked(r, k, v, w, u, s0)
    return wkv_scan(r, k, v, w, u, s0)


def wkv_decode(r, k, v, w, u, s):
    """Single-token WKV. r, k, v, w: (B, H, D); s: (B, H, D, D)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", rf,
                       s + u.float()[None, :, :, None] * kv)
    return out, wf[..., None] * s + kv


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _token_shift(x, last):
    """shifted[t] = x[t-1], with ``last`` filling t=0. x: (B, T, d). A
    sharded ``last`` (the state splits d over the model axis) is first laid
    out as ``x`` (gathered along d): else the shift, and every product of
    it, would be split along d while the weights split their outputs."""
    last = tp.keep(last, x)
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix(p, x, last, wkv_state, cfg: L.ModelConfig, *, seq_mode: str):
    b, t, d = x.shape
    nh, hd = head_dims(cfg)
    xx = _token_shift(x, last) - x
    xbase = x + xx * p["mix_x"]
    lora = tp.split_heads(torch.tanh(xbase @ p["mix_w1"]),
                          (b, t, N_MIX, LORA_MIX))
    mixes = p["mix_base"] + torch.einsum("btnm,nmd->btnd", lora,
                                         p["mix_w2"])
    xw, xk, xv, xr, xg = [x + xx * mixes[:, :, i] for i in range(N_MIX)]

    r = tp.split_heads(xr @ p["wr"], (b, t, nh, hd))
    k = tp.split_heads(xk @ p["wk"], (b, t, nh, hd))
    v = tp.split_heads(xv @ p["wv"], (b, t, nh, hd))
    g = F.silu(xg @ p["wg"])

    decay = p["decay_base"] + (torch.tanh(xw @ p["decay_w1"])
                               @ p["decay_w2"]).float()
    # the clip keeps |log w| <= e^0.5, so the chunked forms' factored
    # exponents stay f32-safe; every form sees the same w
    w = tp.split_heads(torch.exp(-torch.exp(decay.clamp(-20.0, 0.5))),
                       (b, t, nh, hd))

    if tp.is_dt(r):
        out, new_s = tp.wkv(r, k, v, w, p["bonus_u"], wkv_state, seq_mode)
    elif seq_mode == "train":
        out, new_s = wkv_sequence(r, k, v, w, p["bonus_u"], wkv_state)
    else:
        out, new_s = ops.wkv6_op(r, k, v, w, p["bonus_u"], wkv_state,
                                 seq_mode)

    # per-head group norm (population variance), in f32
    mu = out.mean(dim=-1, keepdim=True)
    var = (out - mu).square().mean(dim=-1, keepdim=True)
    out = tp.merge_heads((out - mu) * torch.rsqrt(var + 64e-5), (b, t, d))
    out = out * p["ln_out_scale"].float() + p["ln_out_bias"].float()
    out = out.to(x.dtype) * g
    return tp.rows_layout(out @ p["wo"], x), x[:, -1, :], new_s


def _channel_mix(p, x, last):
    xx = _token_shift(x, last) - x
    xk = x + xx * p["mix_k"]
    xr = x + xx * p["mix_r"]
    k = torch.relu(xk @ p["wk"]).square()
    return (torch.sigmoid(xr @ p["wr"]) * tp.rows_layout(k @ p["wv"], x),
            x[:, -1, :])


def _block(bp, x, state, cfg: L.ModelConfig, seq_mode: str):
    ts_tm, ts_cm, wkv_s = state
    h = L.apply_norm(bp["norm_tm"], x, cfg)
    tm_out, new_ts_tm, new_wkv = _time_mix(bp["tm"], h, ts_tm, wkv_s, cfg,
                                           seq_mode=seq_mode)
    x = tp.keep(x + tm_out, x)
    h = L.apply_norm(bp["norm_cm"], x, cfg)
    cm_out, new_ts_cm = _channel_mix(bp["cm"], h, ts_cm)
    return tp.keep(x + cm_out, x), (new_ts_tm, new_ts_cm, new_wkv)


def _run(params, x, state, cfg: L.ModelConfig, seq_mode: str):
    """The blocks in order (``lax.scan`` over layers becomes a loop); each
    layer's state is overwritten in place."""
    names = ("ts_tm", "ts_cm", "wkv")
    for i in range(cfg.num_layers):
        x, new = _block(L.layer(params["blocks"], i), x,
                        tuple(state[n][i] for n in names), cfg, seq_mode)
        for n, value in zip(names, new):
            state[n][i].copy_(value)
    return x, state


# ---------------------------------------------------------------------------
# entry points (the dense model's interface)
# ---------------------------------------------------------------------------


def prefill(params, state, tokens, lengths, cfg: L.ModelConfig):
    """Prefill of tokens (B, S) from ``state``. Linear-state models have no
    per-position cache: the executor runs requests one at a time, so every
    row's tokens are real. Returns (logits at lengths-1 (B, V), state)."""
    x = L.embed(params["embed"], tokens, cfg)
    x, state = _run(params, x, state, cfg, "chunked")
    b, s, _ = x.shape
    idx = (lengths.long() - 1).clamp(0, s - 1)
    last = L.take_rows(x, idx)
    last = L.apply_norm(params["final_norm"], last[:, None], cfg)
    return L.unembed(params["embed"], last, cfg)[:, 0], state


def _train_block(bp, x, state, cfg: L.ModelConfig):
    return _block(bp, x, state, cfg, "train")[0]


def forward_train(params, tokens, cfg: L.ModelConfig):
    """tokens (B, S) -> logits (B, S, V) f32, as the JAX ``forward_train``:
    every block from a fresh (zero) state, which nothing writes, under
    full rematerialisation (JAX's ``jax.checkpoint`` with no policy); the
    WKV through ``wkv_sequence``'s plain forms, never the kernel."""
    x = L.embed(params["embed"], tokens, cfg)
    b = x.shape[0]
    nh, hd = head_dims(cfg)
    shift = torch.zeros((b, cfg.d_model), dtype=cfg.dtype, device=x.device)
    s0 = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    block = L.remat(functools.partial(_train_block, cfg=cfg), "full")
    for bp in L.unstack(params["blocks"]):
        x = block(bp, x, (shift, shift, s0))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def lm_loss(params, batch, cfg: L.ModelConfig):
    return L.softmax_xent(forward_train(params, batch["tokens"], cfg),
                          batch["labels"])


def decode(params, state, tokens, lengths, cfg: L.ModelConfig):
    """One decode step of tokens (B,); ``lengths`` is unused (the state is
    the whole context). Returns (logits (B, V), state)."""
    x = L.embed(params["embed"], tokens[:, None], cfg)
    x, state = _run(params, x, state, cfg, "decode")
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)[:, 0], state
