"""Mamba-2 (SSD, state-space duality) layer: chunked scan and O(1) decode
(port of ``repro.models.mamba2``).

Prefill splits the sequence into chunks of Q tokens.  Inside a chunk the
quadratic "attention-like" form runs; across chunks a ``[H, P, N]`` state
is carried by a loop over the chunks.  Decode advances the recurrent
state by one token: no KV cache, only ``[B, H, P, N]`` and a conv tail.

The model takes ``ssd_chunked(..., use_kernels=True)``: the intra-chunk
block goes through ``ops.ssd_chunk`` (the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor).  ``use_kernels=False`` is the einsum
form in the inputs' dtype, as JAX's ``use_kernels=False`` branch computes
it (``kernels.ssd_chunk.ssd_intra_chunk``; the kernel's plain version runs
the same math in fp32).

Projections are stored unpacked (``in_z``, ``in_x``, ``in_B``, ``in_C``,
``in_dt`` and one depthwise conv each for x, B and C), as the JAX package
stores them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk
from repro_torch.models.layers import normal
# JAX's mamba2._segsum, under its name
from repro_torch.kernels.ssd_chunk import segsum as _segsum  # noqa: F401

PARAM_NAMES = ("in_z", "in_x", "in_B", "in_C", "in_dt", "conv_x", "conv_b_x",
               "conv_B", "conv_b_B", "conv_C", "conv_b_C", "dt_bias",
               "A_log", "D", "norm", "out_proj")


class Mamba(nn.Module):
    """One Mamba-2 mixer's weights, named as the JAX package's dict keys.
    Created frozen; the trainer turns gradients on
    (``train.loop.trainable``)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        missing = set(PARAM_NAMES) - set(tensors)
        if missing:
            raise KeyError(f"mamba weights missing {sorted(missing)}")
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))


def init_mamba(generator: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Mamba:
    """Random weights from JAX's distributions, drawn by ``generator`` on
    its own device: projections N(0, 1/fan_in), convs N(0, 0.04), zero
    biases and norm, ``A_log = log(linspace(1, 16, H))``, ``D = 1``."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    dev = generator.device

    def init(*sh):
        return (normal(sh, generator) / np.sqrt(sh[0])).to(dtype)

    def conv(c):
        return (normal((K, c), generator) * 0.2).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return Mamba({
        "in_z": init(d, di), "in_x": init(d, di), "in_B": init(d, N),
        "in_C": init(d, N), "in_dt": init(d, H),
        "conv_x": conv(di), "conv_b_x": zeros(di),
        "conv_B": conv(N), "conv_b_B": zeros(N),
        "conv_C": conv(N), "conv_b_C": zeros(N),
        "dt_bias": zeros(H),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "norm": zeros(di),
        "out_proj": init(di, d),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, width K: [B,S,C] -> [B,S,C] (+SiLU)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i : i + S] * w[i]
    return F.silu(out + b)


def _conv_step(window: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One-token conv: window [B,K,C] -> [B,C] (+SiLU)."""
    return F.silu((window * w[None]).sum(dim=1) + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None,
                use_kernels: bool = False):
    """SSD scan.  x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N] (G=1).

    ``use_kernels=True`` computes the intra-chunk block (y_diag and the
    chunk states) with ``ops.ssd_chunk`` (where a gradient is wanted,
    through ``ops.SsdChunk``, whose backward is the ssd_chunk backward
    kernel on the card); the inter-chunk recurrence and the off-diagonal
    term are plain PyTorch under autograd either way.

    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q

    a = dt * A[None, None, :]                                   # [B,S,H]
    xbar = x * dt[..., None]                                    # [B,S,H,P]
    ac = a.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)           # [B,nc,H,Q]
    xc = xbar.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    cum = torch.cumsum(ac, dim=-1)                              # [B,nc,H,Q]
    total = cum[..., -1:]
    if use_kernels:
        y_diag, states = ops.ssd_chunk(xc.contiguous(), ac.contiguous(),
                                       Bc.contiguous(), Cc.contiguous())
    else:
        y_diag, states = ssd_intra_chunk(xc, ac, Bc, Cc)

    # inter-chunk recurrence, in the state's dtype
    chunk_decay = torch.exp(total[..., 0])                      # [B,nc,H]
    s = (torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state)
    prev = []
    for c in range(nc):
        prev.append(s)                                          # before chunk c
        s = s * chunk_decay[:, c, :, None, None].to(s.dtype) + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # [B,nc,H,P,N]

    # inter-chunk output: C_i . state_prev, decayed to position i
    in_decay = torch.exp(cum)                                   # [B,nc,H,Q]
    y_off = (torch.einsum("bcin,bchpn->bcihp", Cc, prev_states)
             * in_decay.permute(0, 1, 3, 2)[..., None])
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, s


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """One-token recurrence.  state [B,H,P,N], x [B,H,P], dt [B,H],
    Bm/Cm [B,N] -> (y [B,H,P], new_state)."""
    decay = torch.exp(dt * A[None, :])                          # [B,H]
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm, x)
    state = state * decay[:, :, None, None].to(state.dtype) + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    return y, state


def _rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    var = torch.mean(torch.square(y.to(torch.float32)), dim=-1, keepdim=True)
    return ((y.to(torch.float32) * torch.rsqrt(var + eps)).to(y.dtype)
            * (1.0 + w))


def _project(p: Mamba, cfg: ArchConfig, x: torch.Tensor):
    return (x @ p.in_z, x @ p.in_x, x @ p.in_B, x @ p.in_C, x @ p.in_dt)


def mamba_forward(p: Mamba, cfg: ArchConfig, x: torch.Tensor,
                  initial_state=None, conv_tail=None):
    """Full-sequence forward.  x [B,S,d] -> (out [B,S,d], (state, conv_tails)).

    The conv tails handed on are the last K-1 *unconvolved* x/B/C rows."""
    Bsz, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt = _project(p, cfg, x)
    if conv_tail is not None:
        tx, tB, tC = conv_tail
        xs_c = _causal_conv(torch.cat([tx, xs], 1), p.conv_x,
                            p.conv_b_x)[:, tx.shape[1]:]
        Bm_c = _causal_conv(torch.cat([tB, Bm], 1), p.conv_B,
                            p.conv_b_B)[:, tB.shape[1]:]
        Cm_c = _causal_conv(torch.cat([tC, Cm], 1), p.conv_C,
                            p.conv_b_C)[:, tC.shape[1]:]
    else:
        xs_c = _causal_conv(xs, p.conv_x, p.conv_b_x)
        Bm_c = _causal_conv(Bm, p.conv_B, p.conv_b_B)
        Cm_c = _causal_conv(Cm, p.conv_C, p.conv_b_C)
    tail = cfg.ssm_conv - 1
    new_tail = ((xs[:, S - tail:], Bm[:, S - tail:], Cm[:, S - tail:])
                if tail else None)
    xh = xs_c.reshape(Bsz, S, H, P)
    # softplus and exp in fp32, then the working dtype (mamba2.py:191-192)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias).to(x.dtype)
    A = (-torch.exp(p.A_log.to(torch.float32))).to(x.dtype)
    y, state = ssd_chunked(xh, dt, A, Bm_c, Cm_c, cfg.ssm_chunk,
                           initial_state, use_kernels=True)
    y = y + xh * p.D[None, None, :, None]
    y = _rmsnorm_gated(y.reshape(Bsz, S, di), z, p.norm)
    return y @ p.out_proj, (state, new_tail)


def mamba_decode(p: Mamba, cfg: ArchConfig, x: torch.Tensor, state,
                 conv_tail):
    """One-token decode.  x [B,1,d]; state [B,H,P,N];
    conv_tail (tx [B,K-1,di], tB [B,K-1,N], tC [B,K-1,N])."""
    Bsz = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt = _project(p, cfg, x)
    tx, tB, tC = conv_tail
    wx = torch.cat([tx, xs], dim=1)
    wB = torch.cat([tB, Bm], dim=1)
    wC = torch.cat([tC, Cm], dim=1)
    xs_c = _conv_step(wx, p.conv_x, p.conv_b_x)
    Bm_c = _conv_step(wB, p.conv_B, p.conv_b_B)
    Cm_c = _conv_step(wC, p.conv_C, p.conv_b_C)
    new_tail = (wx[:, 1:], wB[:, 1:], wC[:, 1:])
    xh = xs_c.reshape(Bsz, H, P)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias).to(x.dtype)
    A = (-torch.exp(p.A_log.to(torch.float32))).to(x.dtype)
    y, state = ssd_decode_step(state, xh, dt1, A, Bm_c, Cm_c)
    y = y + xh * p.D[None, :, None]
    y = _rmsnorm_gated(y.reshape(Bsz, 1, di), z[:, :1], p.norm)
    return y @ p.out_proj, (state, new_tail)


def mamba_state_init(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None):
    """Zero state [B,H,P,N] and zero conv tails on ``device`` (default:
    the card)."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.ssm_conv - 1
    dev = resolve_device(device)

    def zeros(*sh):
        return torch.zeros(sh, dtype=dtype, device=dev)

    return zeros(batch, H, P, N), (zeros(batch, K, cfg.d_inner),
                                   zeros(batch, K, N), zeros(batch, K, N))
