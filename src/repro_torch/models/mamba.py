"""Mamba (selective SSM) mixer, used by the Jamba hybrid architecture.
Port of ``repro/models/mamba.py`` (``mamba_dims``, ``init_mamba``,
``_causal_depthwise_conv``, ``_ssm_scan``, ``_ssm_scan_chunked``,
``mamba_train``, ``init_mamba_cache``, ``mamba_decode``).

The recurrence h_t = dA_t * h_{t-1} + dBx_t is a first-order linear scan.
The reference runs it as ``jax.lax.associative_scan`` (a log-depth tree).
Torch has no stable associative scan, so ``_ssm_scan`` is a loop over
time: one fused multiply-add a step writes each state into one (B, S,
d_inner, d_state) tensor, and one batched product reads them all out
against C. Its backward is written out (``_Scan``): the reverse scan
g_t = dL/dh_t + dA_{t+1} g_{t+1}, one fused multiply-add a step, then
dL/ddA_t = g_t h_{t-1} and dL/ddBx_t = g_t at once. For the backward it
keeps dA and the S states: two float32 tensors of (B, S, d_inner,
d_state) a Mamba layer (1.07 GB each at jamba_v0_1_52b's width with B =
8, S = 256), where a log-depth doubling scan would keep about 2 log2(S)
of them (~17 GB there). While one layer's scan is differentiated, its
state gradients and dA's gradient live beside them: two more. The price
is S small launches forward and S backward. The order of the products
differs from the reference's tree, so the two agree to float32 roundoff.
The forward and backward scans run inside ``torch.profiler`` ranges
``mamba_scan`` and ``mamba_scan_backward``, which ``launch/profile_step.py``
reads. On the meta device (``launch/dryrun.py``'s trace, shapes without
values) each of the two loops is one operation over all S steps, which
reads and writes the same bytes and allocates the same tensors.

Above ``SSM_CHUNK`` tokens, when S divides into chunks, the scan runs
chunk by chunk, each chunk seeded by the carried boundary state and
recomputed in the backward (``torch.utils.checkpoint``, where the
reference uses ``jax.checkpoint``); otherwise the whole sequence is one
loop, as in the reference.

dt, dA, dBx and the scan are float32; y is cast back to the input dtype
before the ``silu(z)`` gate. ``torch.nn.functional.softplus`` turns linear
above 20, where ``jax.nn.softplus`` does not: there the two differ by less
than 1e-8, below float32's resolution of such values. ``A_log`` is the
S4D-real initialisation (log 1..d_state on every channel) and ``dt_bias``
the inverse softplus of dt drawn log-uniformly in [1e-3, 0.1]; both and
``D`` are float32 leaves. The functions take the mixer's weights as a
``{name: tensor}`` dict (the reference's parameter dict), so that decode
runs them on compute-dtype copies of the masters. ``mamba_decode``
returns a new (conv, ssm) state, as the xLSTM mixers do: the last
d_conv - 1 inputs in the compute dtype and the float32 SSM state.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init, param

Tensor = torch.Tensor

# Chunk length for long sequences: past it the scan runs a chunk at a time,
# chained by the state at each chunk's end and recomputed in the backward
SSM_CHUNK = 1024


def mamba_dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int]:
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or max(1, math.ceil(d_model / 16))
    return d_inner, dt_rank


class Mamba(nn.Module):
    """Leaves ``in_proj`` (d, 2 d_inner), ``conv_w`` (d_conv, d_inner),
    ``conv_b``, ``x_proj`` (d_inner, dt_rank + 2 d_state), ``dt_proj``
    (dt_rank, d_inner), ``dt_bias``, ``A_log`` (d_inner, d_state), ``D``
    and ``out_proj`` (d_inner, d), as ``init_mamba`` makes them."""

    def __init__(self, d_model: int, cfg: SSMConfig, dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d_inner, dt_rank = mamba_dims(d_model, cfg)
        N = cfg.d_state
        self.cfg = cfg
        self.in_proj = param(dense_init((d_model, 2 * d_inner), generator), dtype, device)
        self.conv_w = param(dense_init((cfg.d_conv, d_inner), generator,
                                       1.0 / math.sqrt(cfg.d_conv)), dtype, device)
        self.conv_b = param(torch.zeros(d_inner), dtype, device)
        self.x_proj = param(dense_init((d_inner, dt_rank + 2 * N), generator), dtype, device)
        self.dt_proj = param(dense_init((dt_rank, d_inner), generator), dtype, device)
        dt_bias = torch.zeros(d_inner)
        if generator is not None:
            u = torch.rand(d_inner, generator=generator, device=generator.device).cpu()
            dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            # inverse softplus, so that softplus(dt_bias) == dt_init
            dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))
        self.dt_bias = param(dt_bias, torch.float32, device)
        # S4D-real initialisation of A
        A = torch.arange(1, N + 1, dtype=torch.float32).repeat(d_inner, 1)
        self.A_log = param(torch.log(A), torch.float32, device)
        self.D = param(torch.ones(d_inner), torch.float32, device)
        self.out_proj = param(dense_init((d_inner, d_model), generator), dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return mamba_train(dict(self.named_parameters()), x, self.cfg)


def _causal_depthwise_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x: (B, S, d_inner); w: (d_conv, d_inner) depthwise causal conv."""
    d_conv = w.shape[0]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = torch.zeros_like(x)
    for i in range(d_conv):  # d_conv is tiny (4): unrolled taps
        out = out + pad[:, i: i + x.shape[1], :] * w[i]
    return out + b


class _Scan(torch.autograd.Function):
    """(dA, dBx, C, h0) -> (y, h_{S-1}) of ``_ssm_scan``, with its backward
    written out as the reverse scan."""

    @staticmethod
    def forward(ctx, dA: Tensor, dBx: Tensor, C: Tensor, h0: Tensor):
        with torch.profiler.record_function("mamba_scan"):
            H = torch.empty_like(dA)  # every state h_t, for the read-out and the backward
            if dA.device.type == "meta":
                # a dry run's trace, which has shapes and no values: the S
                # steps as one operation that reads and writes the same bytes
                torch.addcmul(dBx, dA, H, out=H)
            else:
                h = h0
                for t in range(dA.shape[1]):
                    h = torch.addcmul(dBx[:, t], dA[:, t], h, out=H[:, t])
            y = torch.einsum("bsdn,bsn->bsd", H, C)
        ctx.save_for_backward(dA, C, h0, H)
        return y, H[:, -1].clone()

    @staticmethod
    def backward(ctx, gy: Tensor, gh_last: Tensor):
        dA, C, h0, H = ctx.saved_tensors
        with torch.profiler.record_function("mamba_scan_backward"):
            g = gy[..., None] * C[:, :, None, :]  # dL/dh_t through y_t alone
            gC = torch.einsum("bsd,bsdn->bsn", gy, H)
            g[:, -1] += gh_last
            if dA.device.type == "meta":  # as in the forward: one operation of the same bytes
                g[:, :-1].addcmul_(dA[:, 1:], g[:, 1:])
            else:
                for t in range(dA.shape[1] - 2, -1, -1):  # g_t += dA_{t+1} g_{t+1}
                    g[:, t].addcmul_(dA[:, t + 1], g[:, t + 1])
            gdA = torch.empty_like(dA)
            torch.mul(g[:, 1:], H[:, :-1], out=gdA[:, 1:])
            torch.mul(g[:, 0], h0, out=gdA[:, 0])
            gh0 = dA[:, 0] * g[:, 0]
        return gdA, g, gC, gh0


def _ssm_scan(dA: Tensor, dBx: Tensor, C: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """The scan of h_t = dA_t * h_{t-1} + dBx_t along axis 1 (time) from
    h_{-1} = ``h0``, read out against C: dA, dBx (B, S, D, N), C (B, S, N),
    h0 (B, D, N) -> (y (B, S, D) with y_t = h_t . C_t, h_{S-1})."""
    return _Scan.apply(dA, dBx, C, h0)


def _ssm_scan_chunked(dA: Tensor, dBx: Tensor, C: Tensor) -> Tensor:
    """Memory-bounded y = (scan(dA, dBx) . C): returns (B, S, d_inner)."""
    B, S, D, N = dA.shape
    h = dA.new_zeros(B, D, N)
    if S <= SSM_CHUNK or S % SSM_CHUNK != 0:
        return _ssm_scan(dA, dBx, C, h)[0]
    ys = []
    for lo in range(0, S, SSM_CHUNK):
        part = slice(lo, lo + SSM_CHUNK)
        y, h = checkpoint(_ssm_scan, dA[:, part], dBx[:, part], C[:, part], h,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1)


def mamba_train(w: Mapping[str, Tensor], u: Tensor, cfg: SSMConfig) -> Tensor:
    d_model = u.shape[-1]
    d_inner, dt_rank = mamba_dims(d_model, cfg)
    x, z = torch.chunk(u @ w["in_proj"], 2, dim=-1)
    x = F.silu(_causal_depthwise_conv(x, w["conv_w"], w["conv_b"]))

    proj = x @ w["x_proj"]
    dt, Bmat, Cmat = torch.split(proj, [dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(dt @ w["dt_proj"] + w["dt_bias"]).float()
    A = -torch.exp(w["A_log"])  # (d_inner, d_state)

    dA = torch.exp(dt[..., None] * A)  # (B, S, d_inner, d_state)
    dBx = (dt * x.float())[..., None] * Bmat.float()[:, :, None, :]
    y = _ssm_scan_chunked(dA, dBx, Cmat.float())
    y = y + w["D"] * x.float()
    y = y.to(u.dtype) * F.silu(z)
    return y @ w["out_proj"]


def init_mamba_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                     device) -> Dict[str, Tensor]:
    """The last d_conv - 1 inputs of the convolution (compute dtype) and the
    float32 SSM state, zeroed."""
    d_inner, _ = mamba_dims(d_model, cfg)
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_inner, cfg.d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode(w: Mapping[str, Tensor], u: Tensor, cache: Mapping[str, Tensor],
                 cfg: SSMConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """u: (B, 1, d_model) -> (y (B, 1, d_model), new cache)."""
    d_model = u.shape[-1]
    d_inner, dt_rank = mamba_dims(d_model, cfg)
    x, z = torch.chunk(u[:, 0] @ w["in_proj"], 2, dim=-1)  # (B, d_inner)

    conv_in = torch.cat([cache["conv"], x[:, None, :]], dim=1)  # (B, d_conv, d_inner)
    x = F.silu(torch.einsum("bcd,cd->bd", conv_in, w["conv_w"]) + w["conv_b"])

    proj = x @ w["x_proj"]
    dt, Bmat, Cmat = torch.split(proj, [dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(dt @ w["dt_proj"] + w["dt_bias"]).float()
    A = -torch.exp(w["A_log"])
    dA = torch.exp(dt[..., None] * A)  # (B, d_inner, d_state)
    dBx = (dt * x.float())[..., None] * Bmat.float()[:, None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cmat.float()) + w["D"] * x.float()
    y = y.to(u.dtype) * F.silu(z)
    return (y @ w["out_proj"])[:, None, :], {"conv": conv_in[:, 1:].contiguous(), "ssm": h}
