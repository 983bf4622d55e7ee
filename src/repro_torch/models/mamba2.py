"""Mamba-2 (SSD, arXiv:2405.21060) block in PyTorch, as zamba2 uses it.

Counterpart of ``repro/models/mamba2.py``. Selective state space with a
scalar decay per head and step:

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t ⊗ B_t        (d_head × d_state)
    y_t = C_t · S_t + D_h x_t

The SSD has no Pallas kernel in the JAX package, so it is plain torch ops
here. Every sequence form computes the chunked-parallel decomposition
(every exponent <= 0, so f32-safe) with the chunks' products batched and
only the chunk-to-chunk state pass sequential: a Python loop over tokens
would launch hundreds of thousands of kernels for one prompt at full
width. ``ssd_scan`` (the JAX sequential oracle's function) pads its tail
to a whole chunk with dt = 0 and x = B = C = 0, rows that leave the state
unchanged (decay exp(0) = 1, update 0) and whose outputs are dropped: the
same function as the scan, its f32 sums in another order.

Parameters keep the JAX pytree; ``A_log``, ``dt_bias``, ``D`` and the
``ssd`` state stay f32 in a bf16 model. State per layer: conv states
(B, conv_k - 1, d_inner) and (B, conv_k - 1, 2 * d_state), the SSD state
(B, H, 64, d_state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.layers import ModelConfig

D_HEAD = 64
CHUNK = 64


def dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // D_HEAD
    d_conv_in = d_inner + 2 * cfg.ssm_state   # x + B + C (n_groups = 1)
    return d_inner, n_heads, d_conv_in


def init_block(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    """A block's weights (``stack`` > 0: that many along a new leading
    axis), with the JAX initialisers' distributions and constants."""
    d_inner, n_heads, _ = dims(cfg)
    n, d, dt, dev = cfg.ssm_state, cfg.d_model, cfg.dtype, gen.device
    lead = (stack,) if stack else ()

    def dense(shape):
        return L._dense_init(gen, shape, dt, stack=stack)

    def full(shape, value, dtype=dt):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    return {
        "norm": L.init_norm(cfg, dev, stack=stack),
        "in_z": dense((d, d_inner)),
        "in_x": dense((d, d_inner)),
        "in_b": dense((d, n)),
        "in_c": dense((d, n)),
        "in_dt": dense((d, n_heads)),
        "conv_wx": dense((cfg.ssm_conv, d_inner)),
        "conv_bx": full((d_inner,), 0.0),
        "conv_wbc": dense((cfg.ssm_conv, 2 * n)),
        "conv_bbc": full((2 * n,), 0.0),
        "A_log": full((n_heads,), 0.0, torch.float32),      # A = -exp(A_log)
        "dt_bias": full((n_heads,), -2.0, torch.float32),
        "D": full((n_heads,), 1.0, torch.float32),
        "gate_norm": {"scale": full((d_inner,), 0.0)},
        "out_proj": dense((d_inner, d)),
    }


def init_state(cfg: ModelConfig, batch: int, device, stack: int = 0):
    d_inner, n_heads, _ = dims(cfg)
    lead = ((stack,) if stack else ()) + (batch,)
    k = cfg.ssm_conv - 1
    return {
        "conv_x": torch.zeros(lead + (k, d_inner), dtype=cfg.dtype,
                              device=device),
        "conv_bc": torch.zeros(lead + (k, 2 * cfg.ssm_state),
                               dtype=cfg.dtype, device=device),
        "ssd": torch.zeros(lead + (n_heads, D_HEAD, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, D, s0, chunk: int = CHUNK):
    """Chunked-parallel SSD (all exponents <= 0), T a multiple of ``chunk``.
    x: (B,T,H,P); dt: (B,T,H); A: (H,); Bm/Cm: (B,T,N); s0: (B,H,P,N).
    Returns (y f32 (B,T,H,P), sT f32). Each chunk's intra-chunk and
    state-readout products run batched over all chunks; the state passes
    from chunk to chunk in a loop of n = T / chunk steps."""
    b, t, h, p = x.shape
    n_state = Bm.shape[-1]
    assert t % chunk == 0
    n = t // chunk
    xf = x.float().view(b, n, chunk, h, p).transpose(2, 3)     # (B,n,H,C,P)
    dtf = dt.float().view(b, n, chunk, h).transpose(2, 3)      # (B,n,H,C)
    bf = Bm.float().view(b, n, chunk, n_state)                 # (B,n,C,N)
    cf = Cm.float().view(b, n, chunk, n_state)

    cum = torch.cumsum(dtf * A[:, None], dim=-1)               # log-decay <= 0
    total = cum[..., -1:]                                      # (B,n,H,1)
    # intra-chunk: Att[i,j] = (C_i.B_j) exp(cum[i]-cum[j]) dt_j, j <= i
    cb = torch.einsum("bzin,bzjn->bzij", cf, bf)               # (B,n,C,C)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~mask,
                                                                -torch.inf)
    att = cb[:, :, None] * torch.exp(diff) * dtf[..., None, :]
    y = torch.einsum("bzhij,bzhjp->bzhip", att, xf)
    # each chunk's own update: sum_j exp(tot-cum[j]) dt_j x_j B_j
    k_dec = (dtf * torch.exp(total - cum))[..., None] * xf     # (B,n,H,C,P)
    upd = torch.einsum("bzhcp,bzcn->bzhpn", k_dec, bf)         # (B,n,H,P,N)
    # the state entering each chunk: S' = exp(tot) S + upd
    decay = torch.exp(total)[..., None]                        # (B,n,H,1,1)
    s = s0.float()
    entering = []
    for z in range(n):
        entering.append(s)
        s = decay[:, z] * s + upd[:, z]
    # state readout: y_i += C_i . (exp(cum[i]) S)
    c_dec = cf[:, :, None] * torch.exp(cum)[..., None]         # (B,n,H,C,N)
    y = y + torch.einsum("bzhcn,bzhpn->bzhcp", c_dec,
                         torch.stack(entering, dim=1))
    y = y.transpose(2, 3).reshape(b, t, h, p)
    return y + D[:, None] * x.float(), s


def ssd_scan(x, dt, A, Bm, Cm, D, s0):
    """The sequential oracle's function for any T: the tail padded to a
    whole chunk with dt = 0 and x = B = C = 0 (rows that leave the state
    unchanged), ``ssd_chunked`` over it, the padded rows' outputs dropped.
    Shapes as ``ssd_chunked``."""
    t = x.shape[1]
    pad = -t % CHUNK
    if pad:
        x, Bm, Cm = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                     for a in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, s = ssd_chunked(x, dt, A, Bm, Cm, D, s0)
    return y[:, :t], s


def ssd_decode(x, dt, A, Bm, Cm, D, s):
    """One step. x: (B,H,P); dt: (B,H); Bm/Cm: (B,N); s: (B,H,P,N)."""
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A)
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], Bm.float())
    s = decay[..., None, None] * s + upd
    y = torch.einsum("bhpn,bn->bhp", s, Cm.float())
    return y + D[:, None] * xf, s


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def _causal_conv(seq, conv_state, w, bias):
    """seq: (B,T,Dc); conv_state: (B,K-1,Dc) = trailing inputs of the past.
    Returns (out (B,T,Dc), new_state): the state is the last K - 1 inputs
    of the unpadded sequence."""
    k = w.shape[0]
    ext = torch.cat([conv_state.to(seq.dtype), seq], dim=1)
    t = seq.shape[1]
    out = ext[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + t] * w[i]
    new_state = ext[:, -(k - 1):] if k > 1 else conv_state
    return F.silu(out + bias), new_state


def apply_block(bp, x, state, cfg: ModelConfig, seq_mode: str):
    """x: (B,T,d); state: this layer's {conv_x, conv_bc, ssd}. Returns
    (out, new_state), as JAX's: "decode" for T = 1, the chunked form when
    T is a multiple of 64, the scan's function otherwise."""
    d_inner, n_heads, _ = dims(cfg)
    b, t, _ = x.shape
    h = L.apply_norm(bp["norm"], x, cfg)
    z = h @ bp["in_z"]
    xr = h @ bp["in_x"]
    bc = h @ torch.cat([bp["in_b"], bp["in_c"]], dim=-1)
    dt_raw = h @ bp["in_dt"]
    xs, new_conv_x = _causal_conv(xr, state["conv_x"], bp["conv_wx"],
                                  bp["conv_bx"])
    bc, new_conv_bc = _causal_conv(bc, state["conv_bc"], bp["conv_wbc"],
                                   bp["conv_bbc"])
    Bm, Cm = bc.chunk(2, dim=-1)
    dt = F.softplus(dt_raw.float() + bp["dt_bias"])
    A = -torch.exp(bp["A_log"])
    xh = tp.split_heads(xs, (b, t, n_heads, D_HEAD))

    run = tp.ssd if tp.is_dt(xh) else (lambda form, *a: form(*a))
    if seq_mode == "decode":
        y, new_ssd = run(ssd_decode, xh[:, 0], dt[:, 0], A, Bm[:, 0],
                         Cm[:, 0], bp["D"], state["ssd"])
        y = y[:, None]
    elif seq_mode == "chunked" and t % CHUNK == 0 and t >= CHUNK:
        y, new_ssd = run(ssd_chunked, xh, dt, A, Bm, Cm, bp["D"],
                         state["ssd"])
    else:
        y, new_ssd = run(ssd_scan, xh, dt, A, Bm, Cm, bp["D"], state["ssd"])

    y = tp.merge_heads(y, (b, t, d_inner)).to(x.dtype)
    norm = tp.channel_rms_norm if tp.is_dt(y) else L.rms_norm
    y = norm(y * F.silu(z), bp["gate_norm"]["scale"], cfg.norm_eps)
    out = tp.rows_layout(y @ bp["out_proj"], x)
    return out, {"conv_x": new_conv_x, "conv_bc": new_conv_bc,
                 "ssd": new_ssd}
